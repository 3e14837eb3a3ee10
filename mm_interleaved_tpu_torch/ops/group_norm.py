"""Channel-last GroupNorm and GroupNorm + SiLU, with their CUDA kernels
(counterpart of `mm_interleaved_tpu/ops/group_norm.py`).

The math is the JAX package's: fp32 per-channel sums ``s1 = sum(x)`` and
``s2 = sum(x^2)`` over the spatial dims, folded to groups, ``var = E[x^2] -
E[x]^2``, then one multiply-add ``x * w[b, c] + b[b, c]`` with ``w = scale *
rsqrt(var + eps)`` and ``b = bias - mean * w`` (`F.group_norm` computes
otherwise), and for `group_norm_silu` a silu in fp32 before the cast to x's
dtype.  On the TPU XLA fuses the moments into one read pass; on the card
both halves are kernels (``csrc/group_norm_silu.cu``), two launches a call:

* `group_norm_moments_cuda` launches the moments kernel: per-chunk channel
  sums, folded by the last chunk of each batch into ``wb [B, 2, C]`` fp32
  (w, b);
* `group_norm_apply_cuda` launches the apply pass ``x * w + b`` (then silu,
  with ``silu``);
* each counts its launches in ``.launches``, runs on PyTorch's current
  stream, takes CUDA tensors only, and raises before any launch on what its
  kernel does not take: at a channel count that is a multiple of 16 bytes
  of x's dtype the kernels load 16-byte vectors, and there a base off a
  16-byte boundary is refused (no slower body is taken instead);
* `gn_plan` is the grid both kernels run, a pure function of the shape;
* `group_affine` (the moments, as ``w, b``; `group_norm_moments_plain`
  stacks them as the moments kernel returns them), `group_norm_apply_plain`
  and `group_norm_plain` (both) are the plain versions: the CPU path, and
  on the card the reference the kernels are held against;
* `GroupNormSiLUFunction` is the differentiable op on either device: its
  forward is the two kernels (the plain versions on a CPU tensor), its
  backward recomputes the plain versions under autograd, as the JAX
  package's backward stays XLA (``_pallas_apply_silu_bwd``), so the
  gradient through the moments is kept.

All take ``x [B, ..., C]`` and return x's shape and dtype.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch import nn

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the plan: CTAs of up to 512 threads, each row group at least 8 rows, at
# most about eight CTAs on each of the H100's 132 SMs
_THREADS = 512
_ROWS = 8
_CTAS = 8 * 132
_MAX_CHANNELS = 4096  # csrc/group_norm_silu.cu: kMaxChannels


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


def gn_width(C: int, dtype: torch.dtype) -> int:
    """Values a thread loads along C: 16 bytes of ``dtype`` where C is a
    multiple of them, else 1."""
    width = 16 // (torch.finfo(dtype).bits // 8)
    return width if C % width == 0 else 1


def gn_plan(B: int, N: int, C: int, dtype: torch.dtype
            ) -> Tuple[int, int, int, int]:
    """``(width, threads, chunks, rows)`` of both kernels for ``x [B, N,
    C]``: each thread owns one column vector of ``width`` channels, a CTA
    has ``threads // (C // width)`` row groups, and the N rows of each batch
    fall into ``chunks`` chunks of ``rows`` rows (the last one shorter):
    at least `_ROWS` rows a row group, at most about `_CTAS` CTAs in
    all."""
    width = gn_width(C, dtype)
    nvec = C // width
    if nvec > 1024 or C > _MAX_CHANNELS:
        raise ValueError(f"group_norm: {C} channels, at most "
                         f"{_MAX_CHANNELS} (and 1024 vectors a row)")
    groups = max(1, _THREADS // nvec)
    chunks = max(1, min(-(-_CTAS // B), -(-N // (groups * _ROWS))))
    rows = -(-N // chunks)
    return width, groups * nvec, -(-N // rows), rows


# a zeroed counter per batch, per (device, stream), kept between calls: the
# moments kernel's last CTA of a batch resets its counter, so the buffer
# stays zero for the next call on that stream without a launch to clear it
# (calls on one stream run in order; another stream gets its own buffer)
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _counters_for(x: torch.Tensor, B: int) -> torch.Tensor:
    key = (x.device.index, stream_of(x))
    buf = _counters.get(key)
    if buf is None or buf.numel() < B:
        buf = torch.zeros(max(B, 64), dtype=torch.int32, device=x.device)
        _counters[key] = buf
    return buf


def _check(name: str, x: torch.Tensor, *params: torch.Tensor):
    """The checks both kernels share; returns ``(B, N, C, plan)``.  Shape,
    layout and alignment come before the device check."""
    if x.dim() < 2 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x {tuple(x.shape)} {x.dtype}")
    B, C = x.shape[0], x.shape[-1]
    N = x.numel() // max(B * C, 1)
    plan = gn_plan(max(B, 1), max(N, 1), C, x.dtype)
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if plan[0] > 1 and x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary at "
                         f"C = {C} ({x.dtype})")
    check_cuda(name, (x,) + params)
    forbid_grad(name, x, *params)
    return B, N, C, plan


def _launch_moments(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float) -> torch.Tensor:
    """Launch the moments kernel; returns ``wb [B, 2, C]`` fp32."""
    name = "group_norm_moments"
    C = x.shape[-1]
    for t in (scale, bias):
        if t.shape != (C,) or t.dtype not in _DTYPE_CODE \
                or t.dtype != scale.dtype:
            raise ValueError(f"{name}: scale/bias {tuple(t.shape)} {t.dtype}, "
                             f"needs ({C},) float32 or bfloat16, one dtype")
    if num_groups < 1 or C % num_groups:
        raise ValueError(f"{name}: {C} channels in {num_groups} groups")
    B, N, C, (width, threads, chunks, rows) = _check(name, x, scale, bias)
    dev = x.device
    wb = torch.empty((B, 2, C), dtype=torch.float32, device=dev)
    partial = torch.empty((B, chunks, 2, C), dtype=torch.float32, device=dev)
    counters = _counters_for(x, B)
    fn = load_library("group_norm_silu").mmi_group_norm_moments
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int64] * 2 + [ctypes.c_int] * 4 \
        + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(dev.index, _DTYPE_CODE[x.dtype], _DTYPE_CODE[scale.dtype], width,
             x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
             partial.data_ptr(), counters.data_ptr(), wb.data_ptr(), B, N, C,
             num_groups, threads, chunks, rows, eps, stream_of(x))
    raise_on_error(name, err)
    return wb


def _launch_apply(x: torch.Tensor, wb: torch.Tensor,
                  silu: bool) -> torch.Tensor:
    """Launch the apply kernel: ``x * w + b`` (then silu) in x's dtype."""
    name = "group_norm_apply"
    B, C = x.shape[0], x.shape[-1]
    if wb.shape != (B, 2, C) or wb.dtype != torch.float32:
        raise ValueError(f"{name}: wb {tuple(wb.shape)} {wb.dtype}, needs "
                         f"({B}, 2, {C}) float32")
    B, N, C, (width, threads, chunks, rows) = _check(name, x, wb)
    y = torch.empty_like(x)
    fn = load_library("group_norm_silu").mmi_group_norm_apply
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3 \
        + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.device.index, _DTYPE_CODE[x.dtype], width, int(silu),
             x.data_ptr(), wb.data_ptr(), y.data_ptr(), B, N, C, threads,
             chunks, rows, stream_of(x))
    raise_on_error(name, err)
    return y


group_norm_moments_cuda = CountedKernel(_launch_moments)
group_norm_apply_cuda = CountedKernel(_launch_apply)


def group_norm_cuda(x, scale, bias, num_groups: int, eps: float,
                    silu: bool) -> torch.Tensor:
    """The two kernels, nothing between them; an empty x launches none."""
    if x.numel() == 0:
        return torch.empty_like(x)
    wb = group_norm_moments_cuda(x, scale, bias, num_groups, eps)
    return group_norm_apply_cuda(x, wb, silu)


class GroupNormSiLUFunction(torch.autograd.Function):
    """GroupNorm (``silu=False``) or GroupNorm + SiLU over ``x [B, ..., C]``
    with ``scale, bias [C]``: the kernels forward on a CUDA tensor, the
    plain versions on a CPU tensor; backward by recompute through the plain
    versions (moments included) under autograd."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, silu)
        if x.device.type == "cuda":
            return group_norm_cuda(x, scale, bias, num_groups, eps, silu)
        return group_norm_plain(x, scale, bias, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y = group_norm_plain(*ins, *ctx.args)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(y, wanted, dy))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``[B, ..., C]``, computed in fp32, in x's dtype; the
    kernels on a CUDA tensor."""
    return GroupNormSiLUFunction.apply(x.contiguous(), scale, bias,
                                       num_groups, eps, False)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``silu(group_norm(x))`` with the silu taken in fp32 before the cast;
    the kernels on a CUDA tensor."""
    return GroupNormSiLUFunction.apply(x.contiguous(), scale, bias,
                                       num_groups, eps, True)


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
