"""The UNet's GEGLU feed-forward in plain PyTorch: fp32 products, the
gated hidden rounded to x's dtype before the second product."""

from __future__ import annotations

import torch.nn.functional as F


def geglu_fused_eligible(C: int, *tensors) -> bool:
    return True


def geglu_mlp(x, w1, b1, w2, b2):
    Fh = w2.shape[1]
    h = x.float() @ w1.float().t() + b1.float()
    g = (h[..., :Fh] * F.gelu(h[..., Fh:])).to(x.dtype)
    return (g.float() @ w2.float().t() + b2.float()).to(x.dtype)
