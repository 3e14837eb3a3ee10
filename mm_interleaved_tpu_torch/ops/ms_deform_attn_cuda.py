"""The deformable-attention forward kernel and its plain version
(counterpart of `mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py`,
forward only).

* `ms_deform_attn_cuda` launches ``csrc/ms_deform_attn.cu`` on PyTorch's
  current stream.  It takes CUDA tensors only and raises on anything the
  kernel does not take; ``ms_deform_attn_cuda.launches`` counts its
  launches (a launch that raises is not counted).
* `ms_deform_attn_plain` is the same function in plain PyTorch: the gather
  path of the JAX package's `_bilinear_gather_one_level`, summed in the same
  order.  The CPU path and the tests use it; on the card it is the
  reference the kernel is held against.

Both take ``value [N, S, H, D]``, ``loc [N, Q, H, L, P, 2]`` (x, y) in
[0, 1], ``w [N, Q, H, L, P]`` and return ``[N, Q, H*D]`` in the value's
dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .cuda_build import CountedKernel, load_library

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


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the CUDA kernel; raises on input it does not take."""
    tensors = (value, sampling_locations, attention_weights)
    if any(t.device.type != "cuda" or t.device != value.device
           for t in tensors):
        raise ValueError("ms_deform_attn_cuda: all inputs must be on one "
                         "CUDA device")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"ms_deform_attn_cuda: value dtype {value.dtype}")
    loc_dtype = sampling_locations.dtype
    if attention_weights.dtype != loc_dtype or loc_dtype not in (
        value.dtype, torch.float32
    ):
        raise TypeError(
            "ms_deform_attn_cuda: locations and weights must share a dtype, "
            f"the value's or float32 (got {loc_dtype}, "
            f"{attention_weights.dtype}, value {value.dtype})"
        )
    N, S, H, D = value.shape
    L = len(level_shapes)
    if (sampling_locations.dim() != 6 or sampling_locations.shape[0] != N
            or sampling_locations.shape[2] != H
            or sampling_locations.shape[3] != L
            or sampling_locations.shape[5] != 2):
        raise ValueError(
            f"ms_deform_attn_cuda: locations {tuple(sampling_locations.shape)}"
            f" do not match value {tuple(value.shape)} and {L} levels"
        )
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if tuple(attention_weights.shape) != (N, Q, H, L, P):
        raise ValueError(
            f"ms_deform_attn_cuda: weights {tuple(attention_weights.shape)}"
            f" != {(N, Q, H, L, P)}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn_cuda: inputs must be contiguous")

    lib = load_library("ms_deform_attn")
    fn = lib.mmi_ms_deform_attn_fwd
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    out = torch.empty((N, Q, H * D), dtype=value.dtype, device=value.device)
    hw = (ctypes.c_int * (2 * L))(*[s for hw_ in level_shapes for s in hw_])
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = fn(
        value.device.index, _DTYPE_CODE[value.dtype], _DTYPE_CODE[loc_dtype],
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        N, S, Q, H, D, L, P, hw, stream,
    )
    if err != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: cuda error "
                           f"{err}")
    return out


ms_deform_attn_cuda = CountedKernel(_launch)
