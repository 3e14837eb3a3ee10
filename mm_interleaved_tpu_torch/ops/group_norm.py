"""Channel-last GroupNorm, and GroupNorm + SiLU with its CUDA apply kernel
(counterpart of `mm_interleaved_tpu/ops/group_norm.py`).

The moment math is the JAX package's: fp32 per-channel sums ``s1 =
sum(x)`` and ``s2 = sum(x^2)`` over the spatial dims, folded to groups,
``var = E[x^2] - E[x]^2``, then one multiply-add ``x * w[b, c] + b[b, c]``
with ``w = scale * rsqrt(var + eps)`` and ``b = bias - mean * w``
(`F.group_norm` computes otherwise).  The statistics stay plain PyTorch,
as they stay XLA on the TPU; the apply pass of `group_norm_silu` is the
kernel:

* `group_norm_silu_apply_cuda` launches ``csrc/group_norm_silu.cu``
  (``.launches`` counts its launches) on a CUDA tensor, of any channel
  count: the JAX ``C % 128`` gate is a TPU lane rule;
* `group_norm_silu_apply_plain` is the same pass in plain PyTorch: silu in
  fp32, then the cast, as the TPU kernel does.  The CPU path uses it; on the
  card it is the reference the kernel is held against.

Both take ``x [B, ..., C]`` and ``w, b [B, C]`` fp32 and return x's shape
and dtype.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch import nn

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``[B, ..., C]``, computed in fp32, in x's dtype."""
    w, b = group_affine(x, scale, bias, num_groups, eps)
    return (x.float() * _bshape(x, w) + _bshape(x, b)).to(x.dtype)


def group_norm_silu_apply_plain(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    t = x.float() * _bshape(x, w) + _bshape(x, b)
    return (t * torch.sigmoid(t)).to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """Launch the CUDA kernel; raises on input it does not take."""
    name = "group_norm_silu"
    check_cuda(name, (x,))
    forbid_grad(name, x, w, b)
    B, C = x.shape[0], x.shape[-1]
    for t in (w, b):
        if t.shape != (B, C) or t.dtype != torch.float32:
            raise ValueError(f"{name}: affine {tuple(t.shape)} {t.dtype}, "
                             f"needs ({B}, {C}) float32")
    check_cuda(name, (w, b, x), dtypes=(torch.float32,))
    N = x.numel() // max(B * C, 1)
    out = torch.empty_like(x)
    width = 16 // x.element_size()
    vectorised = int(C % width == 0 and x.data_ptr() % 16 == 0
                     and out.data_ptr() % 16 == 0)
    fn = load_library("group_norm_silu").mmi_group_norm_silu_apply
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.device.index, _DTYPE_CODE[x.dtype], vectorised, x.data_ptr(),
             w.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, C,
             stream_of(x))
    raise_on_error(name, err)
    return out


group_norm_silu_apply_cuda = CountedKernel(_launch)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``silu(group_norm(x))`` with the silu taken in fp32 before the cast;
    the apply pass is the CUDA kernel on a CUDA tensor."""
    w, b = group_affine(x, scale, bias, num_groups, eps)
    if x.device.type == "cuda":
        return group_norm_silu_apply_cuda(x.contiguous(), w, b)
    return group_norm_silu_apply_plain(x, w, b)


class GroupNorm(nn.Module):
    """GroupNorm over the last axis with the JAX package's moment math;
    params ``weight``/``bias`` (JAX ``scale``/``bias``)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def init_weights(self, g: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps)


class GroupNormSiLU(GroupNorm):
    """``silu(GroupNorm(x))`` through `group_norm_silu`; the same params."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps)
