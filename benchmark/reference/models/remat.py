"""Rematerialisation (counterpart of flax's ``nn.remat`` on the JAX
package's decoder layers and UNet blocks)."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def remat_call(enabled: bool, fn, *args):
    """``fn(*args)``; when ``enabled`` and autograd records, its
    activations are dropped and recomputed in the backward (non-reentrant
    `torch.utils.checkpoint`), so the kernels it launches run again
    there."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
