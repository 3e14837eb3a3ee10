"""GroupNorm (and GroupNorm + SiLU) over the last axis in plain PyTorch,
with fp32 moments."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def group_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 num_groups: int, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) fp32 multiplier and offset ``[B, C]`` that fold
    the group statistics of ``x [B, ..., C]`` with the affine params."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"{C} channels in {num_groups} groups")
    cpg = C // num_groups
    B = x.shape[0]
    xf = x.float().reshape(B, -1, C)
    s1 = xf.sum(dim=1)
    s2 = (xf * xf).sum(dim=1)
    n = float(xf.shape[1] * cpg)
    mean = s1.reshape(B, num_groups, cpg).sum(-1) / n
    var = s2.reshape(B, num_groups, cpg).sum(-1) / n - mean * mean
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(cpg, dim=-1)
    mean_c = mean.repeat_interleave(cpg, dim=-1)
    w = scale.float()[None, :] * inv_c
    b = bias.float()[None, :] - mean_c * w
    return w, b


def _bshape(x, t):
    return t.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],))


def group_norm_moments_plain(x, scale, bias, num_groups: int,
                             eps: float) -> torch.Tensor:
    """`group_affine` as the moments kernel returns it: ``wb [B, 2, C]``."""
    return torch.stack(group_affine(x, scale, bias, num_groups, eps), dim=1)


def group_norm_apply_plain(x: torch.Tensor, wb: torch.Tensor,
                           silu: bool) -> torch.Tensor:
    """``x * w + b`` in fp32 (then silu), cast to x's dtype."""
    t = x.float() * _bshape(x, wb[:, 0]) + _bshape(x, wb[:, 1])
    if silu:
        t = t * torch.sigmoid(t)
    return t.to(x.dtype)


def group_norm_plain(x, scale, bias, num_groups: int, eps: float,
                     silu: bool) -> torch.Tensor:
    return group_norm_apply_plain(
        x, group_norm_moments_plain(x, scale, bias, num_groups, eps), silu)


# --------------------------------------------------------------------------
# the kernels


class GroupNorm(nn.Module):
    """GroupNorm over the last axis; params ``weight``/``bias``."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_plain(x, self.weight, self.bias, self.num_groups,
                                self.eps, False)


class GroupNormSiLU(GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_plain(x, self.weight, self.bias, self.num_groups,
                                self.eps, True)
