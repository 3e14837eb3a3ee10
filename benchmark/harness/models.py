"""The two sides of a cell: the program under test (the PyTorch port, its
model made with the benchmark's weights, behind its `LocalGenerator`) and
the plain reference (`benchmark.reference`, float32, the same weights,
worked out again from the seed)."""

from __future__ import annotations

import torch

from . import weights
from .dataclass_dict import from_dict, with_dtype

QUANT_MODES = (None, "int8")


def program(spec: dict, seed: int, device):
    """The program's runtime: `LocalGenerator` over the configuration's
    model, allocated empty in its dtype and filled with the seeded
    weights, quantized as the configuration says."""
    from mm_interleaved_tpu_torch.models.mm_interleaved import (
        MMInterleavedConfig, allocate_model)
    from mm_interleaved_tpu_torch.parallel.inference import LocalGenerator

    cfg = from_dict(MMInterleavedConfig, spec["model"])
    model = allocate_model(cfg, device, getattr(torch, spec["dtype"]))
    weights.fill(model, seed)
    model.eval()
    return LocalGenerator(model, quantize=spec.get("quantize"))


def reference_config(spec: dict, image_decoder: bool = True):
    from ..reference.models.mm_interleaved import MMInterleavedConfig

    d = with_dtype(spec["model"], "float32")
    if not image_decoder:
        d = dict(d, image_decoder=None)
    return from_dict(MMInterleavedConfig, d)


def reference(spec: dict, seed: int, device, image_decoder: bool = True,
              transform=None):
    """The plain reference in float32 with the same weights: the
    projections the configuration quantizes are quantized and dequantized
    here by the reference's own arithmetic (`reference.quant`).
    ``transform(name, w)`` rounds the weights further (a control)."""
    from ..reference import quant
    from ..reference.models.mm_interleaved import MMInterleaved

    cfg = reference_config(spec, image_decoder)
    with torch.device("meta"):
        model = MMInterleaved(cfg)
    model = model.to_empty(device=device)
    mode = spec.get("quantize")
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantize mode {mode!r}")
    names = quant.quantized_weights(model) if mode == "int8" else set()

    def prepare(name, w):
        if name in names:
            w = quant.int8_roundtrip(w)
        w = w.float()
        return transform(name, w) if transform is not None else w

    weights.fill(model, seed, prepare)
    return model.eval()
