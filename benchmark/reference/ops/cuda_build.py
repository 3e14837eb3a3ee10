"""The one helper of the program's kernel module that the model code uses."""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None entries are
    skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
