"""The one traffic generator: it reads a mix's data file
(``benchmark/traffic/<mix>.json``) and makes each unit's inputs from the
run's seed.

A request is an interleaved document: ``<bos>``, ``lead_text`` tokens,
then ``blocks`` blocks of an image (``<soi>`` and ``num_img_token``
``<image>`` placeholders, one image slot) followed by ``block_text``
tokens, then the ``final`` part: ``"image"`` (a target image block, whose
slot the image path generates), or ``"image_text"`` (a query image and
``final_text`` tokens, which the text path answers).  Each ``[lo, hi]``
range is drawn uniformly, once, for the ``batch`` requests of a unit from
``template_seed``: every unit of every seed holds the same multiset of
request sizes, so every unit has the same shapes and the same work.  The
run's seed and the unit's index choose the order of the requests in the
unit and of the blocks in a request, the token ids (in ``[10, 30000)``,
the range of the program's old bench prompt,
`benchmark.yardstick.prompts`) and the images' pixels."""

from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

from ..yardstick.prompts import random_text

ENTRIES = ("generate_images", "generate_texts")


def mix_seed(seed: int, *parts) -> int:
    h = zlib.crc32(repr(parts).encode())
    return (int(seed) * 0x5851F42D + h) % (1 << 62)


def _draw(rng: np.random.RandomState, span) -> int:
    lo, hi = span
    return int(rng.randint(lo, hi + 1))


def templates(spec: dict) -> List[dict]:
    """The ``batch`` request sizes of every unit: lead text, each block's
    text, the final text."""
    rng = np.random.RandomState(spec["template_seed"])
    out = []
    for _ in range(spec["batch"]):
        n_blocks = _draw(rng, spec["blocks"])
        out.append(dict(
            lead=_draw(rng, spec.get("lead_text", [0, 0])),
            blocks=[_draw(rng, spec["block_text"]) for _ in range(n_blocks)],
            final=_draw(rng, spec.get("final_text", [0, 0])),
        ))
    return out


def request_tokens(t: dict, rng: np.random.RandomState, special: dict,
                   n_img_tok: int, final: str, vocab: int) -> List[int]:
    image = [special["soi_token_id"]] + [special["image_token_id"]] * n_img_tok
    ids = [special["bos_token_id"]] + random_text(rng, t["lead"], vocab)
    for n in rng.permutation(t["blocks"]) if t["blocks"] else []:
        ids += image + random_text(rng, int(n), vocab)
    ids += image
    if final == "image_text":
        ids += random_text(rng, t["final"], vocab)
    return ids


class Traffic:
    """Unit ``i``'s inputs, on ``device``, for configuration dict
    ``model_cfg`` (the ``model`` entry of a configuration's file)."""

    def __init__(self, spec: dict, model_cfg: dict, seed: int, device):
        if spec["entry"] not in ENTRIES:
            raise ValueError(f"unknown entry {spec['entry']!r}")
        self.spec = spec
        self.seed = int(seed)
        self.device = device
        self.special = model_cfg["special"]
        self.n_img_tok = model_cfg["num_img_token"]
        self.vocab = model_cfg["orig_vocab_size"]
        self.image_size = model_cfg["visual"]["encoder"]["vit"]["image_size"]
        self.templates = templates(spec)
        self.slots = max(len(t["blocks"]) for t in self.templates) + 1

    @property
    def entry(self) -> str:
        return self.spec["entry"]

    @property
    def batch_size(self) -> int:
        return self.spec["batch"]

    def unit(self, i: int) -> Dict[str, torch.Tensor]:
        """``text_ids``, ``attention_mask``, ``image_tensors`` ``[B,
        slots, H, W, 3]`` in [0, 1], ``num_image_per_seq``, and for the
        image path ``target_rows`` (each request's last slot, as rows of
        the image path's ``(b n)`` inputs)."""
        spec = self.spec
        rng = np.random.RandomState(mix_seed(self.seed, "unit", i) % (1 << 32))
        order = rng.permutation(len(self.templates))
        rows = [request_tokens(self.templates[k], rng, self.special,
                               self.n_img_tok, spec["final"], self.vocab)
                for k in order]
        n_img = [len(self.templates[k]["blocks"]) + 1 for k in order]
        L = max(len(r) for r in rows)
        pad = self.special["pad_token_id"]
        ids = np.full((len(rows), L), pad, np.int64)
        att = np.zeros((len(rows), L), np.int32)
        for b, r in enumerate(rows):
            if spec["padding"] == "left":
                ids[b, L - len(r):], att[b, L - len(r):] = r, 1
            else:
                ids[b, :len(r)], att[b, :len(r)] = r, 1
        g = torch.Generator(device=self.device)
        g.manual_seed(mix_seed(self.seed, "pixels", i))
        s = self.image_size
        images = torch.rand((len(rows), self.slots, s, s, 3), generator=g,
                            device=self.device)
        n = torch.tensor(n_img, dtype=torch.int64)
        for b, k in enumerate(n_img):  # empty slots hold zeros
            images[b, k:] = 0
        out = dict(
            text_ids=torch.from_numpy(ids).to(self.device),
            attention_mask=torch.from_numpy(att).to(self.device),
            image_tensors=images,
            num_image_per_seq=n.to(self.device),
        )
        if self.entry == "generate_images":
            out["target_rows"] = (torch.arange(len(rows)) * self.slots
                                  + n - 1).to(self.device)
        return out

    def noise_seed(self, i: int) -> int:
        """The seed of unit ``i``'s denoise generator (its initial latents
        and DDPM noise)."""
        return mix_seed(self.seed, "noise", i)
