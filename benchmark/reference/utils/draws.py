"""Random draws of a rank's rows of a global batch.

A sharded training step (`engine.trainer.Trainer` on a mesh) runs a rank's
rows of a batch that every rank holds whole.  For the step to equal the
one-process step under the same seed, each draw of the forward (the
resamplers' dropout masks, the image decoder's uncond drops, VAE noise,
diffusion noise and timesteps) is made at the global batch from the one
generator, in the one-process order, and the rank keeps its rows of it, as
the sharded runtime does for serving.

`RowDraws` stands where a `torch.Generator` is passed; `rand`, `randn`
and `randint` take either.  A drawn tensor's leading dim is ``k`` entries
a row (a row's image slots, ``(b n)``, or its dropout mask rows): the
global draw has ``batch * k`` of them and the rank keeps entries
``rows.start * k`` to ``rows.stop * k``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """Draws from ``generator`` at a global batch of ``batch`` rows, of
    which this rank holds ``rows``."""

    generator: torch.Generator
    rows: slice
    batch: int


Gen = Optional[Union[torch.Generator, RowDraws]]


def _draw(fn, shape: Sequence[int], generator: Gen, **kw) -> torch.Tensor:
    if not isinstance(generator, RowDraws):
        return fn(size=tuple(shape), generator=generator, **kw)
    local = generator.rows.stop - generator.rows.start
    k, rem = divmod(shape[0], local)
    if rem:
        raise ValueError(f"a draw of {tuple(shape)} is not whole rows of "
                         f"{local}")
    full = fn(size=(generator.batch * k, *shape[1:]),
              generator=generator.generator, **kw)
    return full[generator.rows.start * k:generator.rows.stop * k]


def rand(shape, generator: Gen, device) -> torch.Tensor:
    return _draw(torch.rand, shape, generator, device=device)


def randn(shape, generator: Gen, device) -> torch.Tensor:
    return _draw(torch.randn, shape, generator, device=device)


def randint(low: int, high: int, shape, generator: Gen,
            device) -> torch.Tensor:
    return _draw(lambda **kw: torch.randint(low, high, **kw), shape,
                 generator, device=device)
