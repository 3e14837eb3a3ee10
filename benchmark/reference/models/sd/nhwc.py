"""Channel-last helpers shared by the UNet and the VAE.  Their tensors are
NHWC, as in the JAX package; a convolution permutes to NCHW views (a
channels-last layout, so no copy) around PyTorch's kernel."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` over ``[B, H, W, C]``, computed in the input's dtype
    (the weights are cast where the model's dtype differs, as flax casts
    its params to the op dtype)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = self._conv_forward(x.permute(0, 3, 1, 2), w, b)
        return y.permute(0, 2, 3, 1)


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m(x)`` computed in x's dtype."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, m.weight.to(x.dtype), b)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling of ``[B, H, W, C]``."""
    B, H, W, C = x.shape
    return x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(
        B, 2 * H, 2 * W, C)
