"""Tokenizer setup for interleaved image-text streams.

Re-design of the reference `custom_datasets/wds_utils.py:186-216`
(`init_tokenizer`): a LLaMA tokenizer extended with the ``<|beginofimage|>``
and ``<|image|>`` special tokens, pad pinned to 31999 (inside the original
vocab — the two new ids are 32000/32001).

A hash-based `SimpleWordTokenizer` with the same interface serves tests and
CI where no tokenizer assets exist.

The port's copy of `mm_interleaved_tpu/data/tokenizer.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import List, Optional, Sequence

SOI_TOKEN = "<|beginofimage|>"
IMAGE_TOKEN = "<|image|>"


@dataclasses.dataclass
class SpecialIds:
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    soi_token_id: int
    image_token_id: int


class HFTokenizerWrapper:
    """transformers AutoTokenizer + the two image special tokens."""

    def __init__(self, tokenizer_path: str, pad_token_id: int = 31999):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(tokenizer_path, use_fast=False)
        tok.pad_token_id = pad_token_id
        tok.add_special_tokens(
            {"additional_special_tokens": [SOI_TOKEN, IMAGE_TOKEN]}
        )
        self.tok = tok
        self.special = SpecialIds(
            bos_token_id=tok.bos_token_id,
            eos_token_id=tok.eos_token_id,
            pad_token_id=pad_token_id,
            soi_token_id=tok.convert_tokens_to_ids(SOI_TOKEN),
            image_token_id=tok.convert_tokens_to_ids(IMAGE_TOKEN),
        )
        self.vocab_size = len(tok)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self.tok.encode(text, add_special_tokens=False)
        if add_bos:
            ids = [self.special.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.special.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special)


class SimpleWordTokenizer:
    """Deterministic word-hash tokenizer (tests / no-assets environments).

    ids: 0=pad-unused, 1=bos, 2=eos, [10, vocab-10) words,
    soi/image near the top of the vocab (mirroring LLaMA's 32000/32001).
    """

    def __init__(self, vocab_size: int = 128, pad_token_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.special = SpecialIds(
            bos_token_id=1,
            eos_token_id=2,
            pad_token_id=pad_token_id if pad_token_id is not None
            else vocab_size - 8,
            soi_token_id=vocab_size - 7,
            image_token_id=vocab_size - 6,
        )
        self._lo, self._hi = 10, vocab_size - 10

    def _word_id(self, w: str) -> int:
        h = int(hashlib.md5(w.encode()).hexdigest(), 16)
        return self._lo + h % (self._hi - self._lo)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids: List[int] = []
        # split out special-token strings before word hashing
        for chunk in re.split(r"(<\|\w+\|>)", text):
            if chunk == SOI_TOKEN:
                ids.append(self.special.soi_token_id)
            elif chunk == IMAGE_TOKEN:
                ids.append(self.special.image_token_id)
            else:
                ids.extend(
                    self._word_id(w) for w in re.findall(r"\S+", chunk.lower())
                )
        if add_bos:
            ids = [self.special.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.special.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return " ".join(f"w{i}" for i in ids
                        if not (skip_special and i < 10)
                        and i < self._hi)


def image_subseq_ids(special: SpecialIds, num_img_token: int) -> List[int]:
    """``<soi>`` + N x ``<image>`` (the per-image token block,
    reference inference.py:66)."""
    return [special.soi_token_id] + [special.image_token_id] * num_img_token


def load_tokenizer(tokenizer_path: Optional[str], vocab_size: int = 128,
                   special=None):
    """HF tokenizer when a path is given, test tokenizer otherwise.

    ``special`` (the model config's special tokens) gives the test
    tokenizer the model's ``<soi>``, ``<image>``, pad, bos and eos ids.
    The JAX package's copy places them at ``vocab_size - 8 .. - 6``, which
    equal the model's at the tiny preset only: at the other presets
    (vocabulary 32002, ``<soi>`` 32000) no image block of its batches
    reaches the model, and the image loss is 0."""
    if tokenizer_path:
        return HFTokenizerWrapper(tokenizer_path)
    tok = SimpleWordTokenizer(vocab_size=vocab_size)
    if special is not None:
        tok.special = SpecialIds(**{
            f.name: int(getattr(special, f.name))
            for f in dataclasses.fields(SpecialIds)})
    return tok
