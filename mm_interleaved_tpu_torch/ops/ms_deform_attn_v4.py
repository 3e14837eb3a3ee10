"""Deformable attention as the dense bilinear-matrix product, the v4
formulation (counterpart of `mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py`,
forward only).

Per (batch, head) and level ``l`` the formulation builds the matrix

    A[q, y*w + x] = sum_p  aw_p[q] * hat(x - xs_p[q]) * hat(y - ys_p[q]),

``hat(t) = relu(1 - |t|)`` over the level's row-major texels, rounds A to
the value's dtype and takes ``A @ V_l`` with fp32 accumulation; the levels'
products are summed in order.  ``xs = loc_x * w - 0.5`` (``align_corners=
False``); a texel outside the grid does not exist, so out-of-grid corners
contribute zero, as in `ms_deform_attn`.

* `ms_deform_attn_v4_plain`: that arithmetic in plain PyTorch, in query
  chunks so that A stays bounded (a whole level-0 A of the benchmark's unet
  case would take 4.3 GB).
* `ms_deform_attn_v4_cuda`: the kernel ``csrc/ms_deform_attn_v4.cu``
  (counted, CUDA tensors only, no gradient).
* `ms_deform_attn_v4`: the plain version for CPU tensors, the kernel for
  CUDA tensors.

The TPU kernel's x-major texel layout, lane padding (`_padded_cols`) and
MXU x-expansion with its extra bf16 rounding of the x-weights
(`_build_A_mxu`) work around Mosaic and the MXU; they are not part of the
function and are not carried over.  Shapes as `ms_deform_attn_cuda`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .cuda_build import CountedKernel
from .ms_deform_attn_cuda import launch_forward

# A chunk of the plain version's bilinear matrix stays under this many bytes
_CHUNK_BYTES = 1 << 28
# the kernel's limits: head dim (bf16: a multiple of 16) and points per level
MAX_D = 128
MAX_P = 64


def _hat(t: torch.Tensor) -> torch.Tensor:
    return (1.0 - t.abs()).clamp_min(0.0)


def ms_deform_attn_v4_plain(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    N, S, H, D = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    BH = N * H
    dev = value.device
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)
    loc = loc.reshape(BH, Q, len(level_shapes), P, 2)
    wts = attention_weights.float().permute(0, 2, 1, 3, 4)
    wts = wts.reshape(BH, Q, len(level_shapes), P)
    val = value.permute(0, 2, 1, 3).reshape(BH, S, D)
    acc = None
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        v_l = val[:, start:start + h * w].float()  # exact: value-dtype values
        iy = torch.arange(h, dtype=torch.float32, device=dev)
        ix = torch.arange(w, dtype=torch.float32, device=dev)
        tq = max(1, min(Q, _CHUNK_BYTES // (BH * h * w * 4)))
        parts = []
        for q0 in range(0, Q, tq):
            sl = slice(q0, q0 + tq)
            xs = loc[:, sl, lid, :, 0] * w - 0.5  # [BH, tq, P]
            ys = loc[:, sl, lid, :, 1] * h - 0.5
            aw = wts[:, sl, lid]
            A = None
            for p in range(P):
                wy = _hat(iy - ys[..., p, None]) * aw[..., p, None]  # [BH,tq,h]
                wx = _hat(ix - xs[..., p, None])  # [BH, tq, w]
                contrib = wx[:, :, None, :] * wy[:, :, :, None]
                A = contrib if A is None else A + contrib
            A = A.reshape(BH, -1, h * w).to(value.dtype).float()
            parts.append(torch.bmm(A, v_l))
            del A
        contrib = torch.cat(parts, dim=1)  # [BH, Q, D]
        acc = contrib if acc is None else acc + contrib
        start += h * w
    out = acc.view(N, H, Q, D).permute(0, 2, 1, 3).reshape(N, Q, H * D)
    return out.to(value.dtype)


def _dims(D, P, dtype):
    if D > MAX_D or P > MAX_P or (dtype == torch.bfloat16 and D % 16):
        raise ValueError(f"ms_deform_attn_v4_cuda: head dim {D} (at most "
                         f"{MAX_D}, bf16 a multiple of 16), {P} points (at "
                         f"most {MAX_P})")


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the v4 forward kernel; raises on input it does not take."""
    return launch_forward("ms_deform_attn_v4_cuda", "ms_deform_attn_v4",
                          value, level_shapes, sampling_locations,
                          attention_weights, _dims)


ms_deform_attn_v4_cuda = CountedKernel(_launch)


def ms_deform_attn_v4(value, level_shapes, sampling_locations,
                      attention_weights) -> torch.Tensor:
    """The v4 formulation: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns ``[N, Q, H*D]`` in the value's dtype."""
    shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    if value.device.type == "cuda":
        return ms_deform_attn_v4_cuda(value, shapes, sampling_locations,
                                      attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_v4_plain(value, shapes, sampling_locations,
                                       attention_weights)
    raise ValueError(f"ms_deform_attn_v4: unsupported device {value.device}")
