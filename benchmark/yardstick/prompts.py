"""The program's old benchmark prompt pattern, frozen here as the
yardstick's: random token ids drawn from a ``numpy`` ``RandomState`` in
``[10, min(30000, vocab))``, below the original vocabulary (copied from
`mm_interleaved_tpu_torch.bench.prompt_row`)."""

from __future__ import annotations

from typing import List

import numpy as np

TOKEN_LO, TOKEN_HI = 10, 30000


def random_text(rng: np.random.RandomState, n: int,
                vocab: int = TOKEN_HI) -> List[int]:
    hi = min(TOKEN_HI, vocab)
    return [int(x) for x in rng.randint(TOKEN_LO, hi, size=n)]
