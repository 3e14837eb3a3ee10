"""The deformable-attention kernels, forward and backward, and their plain
versions (counterpart of `mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py`).

* `ms_deform_attn_cuda` launches the forward, ``csrc/ms_deform_attn.cu``;
  `ms_deform_attn_bwd_value_cuda` and `ms_deform_attn_bwd_loc_weight_cuda`
  launch the two backward kernels of ``csrc/ms_deform_attn_bwd.cu``.  Each
  runs on PyTorch's current stream, takes CUDA tensors only, raises on
  anything its kernel does not take, and counts its launches in
  ``.launches`` (a launch that raises is not counted).  `launch_forward`
  serves every forward of the same C signature: kernel 1 and the
  benchmark's v1 and v4 kernels (`ms_deform_attn_v1`, `ms_deform_attn_v4`).
  `loc_weight_variant` (a pure function of D and the dtype) picks the
  location/weight gradient's body: "grouped" (a group of lanes a sample,
  16-byte loads; a misaligned value or dOut is refused before launch) or
  "warp" (any D).
* `MSDeformAttnFunction` is the differentiable op on the card: its forward
  launches the forward kernel, its backward the two backward kernels.  The
  bare forward wrapper refuses a call that autograd records.
* `ms_deform_attn_plain` is the same function in plain PyTorch: the gather
  path of the JAX package's `_bilinear_gather_one_level`, summed in the same
  order.  The CPU path and the tests use it; `ms_deform_attn_plain_backward`
  differentiates it with autograd.  On the card both are the reference the
  kernels are held against.

All take ``value [N, S, H, D]``, ``loc [N, Q, H, L, P, 2]`` (x, y) in
[0, 1], ``w [N, Q, H, L, P]``; the forward returns ``[N, Q, H*D]`` in the
value's dtype, the backward the gradients in their inputs' dtypes.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .cuda_build import (CountedKernel, forbid_grad, load_library,
                         raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ms_deform_attn_plain(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    N, S, H, D = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    loc32 = sampling_locations.float()
    w32 = attention_weights.float()
    acc = None
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        value_l = value[:, start:start + h * w].permute(0, 2, 1, 3)  # [N,H,hw,D]
        x = loc32[:, :, :, lid, :, 0] * w - 0.5  # [N, Q, H, P]
        y = loc32[:, :, :, lid, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        lx = x - x0
        ly = y - y0
        x0i = x0.long()
        y0i = y0.long()
        idxs, wgts = [], []
        for dx, dy, cw in (
            (0, 0, (1.0 - lx) * (1.0 - ly)),
            (1, 0, lx * (1.0 - ly)),
            (0, 1, (1.0 - lx) * ly),
            (1, 1, lx * ly),
        ):
            ix = x0i + dx
            iy = y0i + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idxs.append(iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
            wgts.append(torch.where(valid, cw, torch.zeros_like(cw)))
        idx = torch.stack(idxs, dim=-1)  # [N, Q, H, P, 4]
        wgt = torch.stack(wgts, dim=-1)
        idx = idx.permute(0, 2, 1, 3, 4).reshape(N, H, Q * P * 4)
        gathered = torch.gather(
            value_l, 2, idx[..., None].expand(N, H, Q * P * 4, D)
        )
        gathered = gathered.view(N, H, Q, P, 4, D).permute(0, 2, 1, 3, 4, 5)
        sampled = (gathered.float() * wgt[..., None]).sum(dim=-2)  # [N,Q,H,P,D]
        contrib = (sampled * w32[:, :, :, lid, :, None]).sum(dim=3)
        acc = contrib if acc is None else acc + contrib
        start += h * w
    return acc.reshape(N, Q, H * D).to(value.dtype)


def ms_deform_attn_plain_backward(value, level_shapes, sampling_locations,
                                  attention_weights, grad_out):
    """``(d_value, d_loc, d_w)`` of `ms_deform_attn_plain` by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_plain(ins[0], level_shapes, ins[1], ins[2])
        return torch.autograd.grad(out, ins, grad_out)


def _check(name, value, level_shapes, sampling_locations, attention_weights,
           *extra):
    """The shapes, dtypes, devices and layout every kernel of the op takes;
    returns ``(N, S, Q, H, D, L, P)``."""
    tensors = (value, sampling_locations, attention_weights) + extra
    if any(t.device.type != "cuda" or t.device != value.device
           for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: value dtype {value.dtype}")
    loc_dtype = sampling_locations.dtype
    if attention_weights.dtype != loc_dtype or loc_dtype not in (
        value.dtype, torch.float32
    ):
        raise TypeError(
            f"{name}: locations and weights must share a dtype, the value's "
            f"or float32 (got {loc_dtype}, {attention_weights.dtype}, value "
            f"{value.dtype})"
        )
    N, S, H, D = value.shape
    L = len(level_shapes)
    if (sampling_locations.dim() != 6 or sampling_locations.shape[0] != N
            or sampling_locations.shape[2] != H
            or sampling_locations.shape[3] != L
            or sampling_locations.shape[5] != 2):
        raise ValueError(
            f"{name}: locations {tuple(sampling_locations.shape)} do not "
            f"match value {tuple(value.shape)} and {L} levels"
        )
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if tuple(attention_weights.shape) != (N, Q, H, L, P):
        raise ValueError(
            f"{name}: weights {tuple(attention_weights.shape)} != "
            f"{(N, Q, H, L, P)}"
        )
    for t in extra:  # the output gradient
        if t.shape != (N, Q, H * D) or t.dtype != value.dtype:
            raise ValueError(f"{name}: grad_out {tuple(t.shape)} {t.dtype}, "
                             f"needs {(N, Q, H * D)} {value.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return N, S, Q, H, D, L, P


def _level_array(level_shapes):
    return (ctypes.c_int * (2 * len(level_shapes)))(
        *[s for hw_ in level_shapes for s in hw_])


def launch_forward(name, library, value, level_shapes, sampling_locations,
                   attention_weights, check_dims=None):
    """Launch the forward kernel ``mmi_<library>_fwd`` of
    ``csrc/<library>.cu`` (the C signature every deformable forward shares);
    ``check_dims(D, P, dtype)`` raises on head and point counts the kernel
    does not take.  Returns ``[N, Q, H*D]`` in the value's dtype."""
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights)
    forbid_grad(name, value, sampling_locations, attention_weights)
    if check_dims is not None:
        check_dims(D, P, value.dtype)
    fn = getattr(load_library(library), f"mmi_{library}_fwd")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((N, Q, H * D), dtype=value.dtype, device=value.device)
    err = fn(
        value.device.index, _DTYPE_CODE[value.dtype],
        _DTYPE_CODE[sampling_locations.dtype],
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value),
    )
    raise_on_error(name, err)
    return out


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the forward kernel; raises on input it does not take."""
    return launch_forward("ms_deform_attn_cuda", "ms_deform_attn", value,
                          level_shapes, sampling_locations, attention_weights)


def _launch_bwd_value(value, level_shapes, sampling_locations,
                      attention_weights, grad_out):
    """Launch the value-gradient kernel: fp32 atomics into a zeroed buffer,
    returned in the value's dtype."""
    name = "ms_deform_attn_bwd_value"
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    fn = load_library("ms_deform_attn_bwd").mmi_ms_deform_attn_bwd_value
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grad = torch.zeros((N, S, H, D), dtype=torch.float32, device=value.device)
    err = fn(value.device.index, _DTYPE_CODE[value.dtype],
             _DTYPE_CODE[sampling_locations.dtype],
             sampling_locations.data_ptr(), attention_weights.data_ptr(),
             grad_out.data_ptr(), grad.data_ptr(), N, S, Q, H, D, L, P,
             _level_array(level_shapes), stream_of(value))
    raise_on_error(name, err)
    return grad.to(value.dtype)


def loc_weight_variant(D: int, dtype: torch.dtype) -> str:
    """The location/weight-gradient body for a head width ``D`` of values in
    ``dtype``: "grouped" where D is 4, 8 or 16 whole 16-byte vectors (a
    group of that many lanes takes a sample), else "warp" (a warp a sample,
    any D)."""
    nbytes = D * (torch.finfo(dtype).bits // 8)
    if nbytes % 16 == 0 and nbytes // 16 in (4, 8, 16):
        return "grouped"
    return "warp"


def _launch_bwd_loc_weight(value, level_shapes, sampling_locations,
                           attention_weights, grad_out):
    """Launch the location/weight-gradient kernel; returns ``(d_loc, d_w)``
    in the dtype of the locations and weights.  The "grouped" body loads
    16-byte vectors of the value and dOut: there a base off a 16-byte
    boundary is refused before any launch."""
    name = "ms_deform_attn_bwd_loc_weight"
    variant = (loc_weight_variant(value.shape[-1], value.dtype)
               if value.dtype in _DTYPE_CODE else "warp")
    if variant == "grouped" and (value.data_ptr() % 16
                                 or grad_out.data_ptr() % 16):
        raise ValueError(f"{name}: value and grad_out must start on a "
                         f"16-byte boundary at D = {value.shape[-1]} "
                         f"({value.dtype})")
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    fn = load_library("ms_deform_attn_bwd").mmi_ms_deform_attn_bwd_loc_weight
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = value.device
    dt = sampling_locations.dtype
    d_loc = torch.empty((N, Q, H, L, P, 2), dtype=dt, device=dev)
    d_w = torch.empty((N, Q, H, L, P), dtype=dt, device=dev)
    err = fn(dev.index, _DTYPE_CODE[value.dtype], _DTYPE_CODE[dt],
             int(variant == "grouped"), value.data_ptr(),
             sampling_locations.data_ptr(), attention_weights.data_ptr(),
             grad_out.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
             N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value))
    raise_on_error(name, err)
    return d_loc, d_w


ms_deform_attn_cuda = CountedKernel(_launch)
ms_deform_attn_bwd_value_cuda = CountedKernel(_launch_bwd_value)
ms_deform_attn_bwd_loc_weight_cuda = CountedKernel(_launch_bwd_loc_weight)


class MSDeformAttnFunction(torch.autograd.Function):
    """The deformable op on the card: the forward kernel, and the two
    backward kernels for whichever gradients autograd asks for."""

    @staticmethod
    def forward(ctx, value, level_shapes, sampling_locations,
                attention_weights):
        ctx.level_shapes = level_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, level_shapes, sampling_locations,
                                   attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, w = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        d_value = d_loc = d_w = None
        if ctx.needs_input_grad[0]:
            d_value = ms_deform_attn_bwd_value_cuda(value, ctx.level_shapes,
                                                    loc, w, grad_out)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            d_loc, d_w = ms_deform_attn_bwd_loc_weight_cuda(
                value, ctx.level_shapes, loc, w, grad_out)
        return d_value, None, d_loc, d_w
