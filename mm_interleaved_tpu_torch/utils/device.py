"""The device an entry point runs on, and numpy batches moved to it
(`train`, `bench`, `bench_train`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device must exist (no silent CPU run)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    return device


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A batch as tensors on ``device``: numpy integer arrays as int64,
    numpy float arrays as fp32 (the images NHWC, the decoder's targets fp32
    for the fp32 VAE encode), tensors moved as they are; other values
    unchanged."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            v = t.long() if not t.is_floating_point() else t.float()
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        out[k] = v
    return out
