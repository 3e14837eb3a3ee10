"""Deformable attention in the separable v1 formulation (counterpart of
`mm_interleaved_tpu/ops/ms_deform_attn_pallas.py`).

Per (level, point) the formulation blends the two rows ``y0`` and
``y0 + 1`` of the level with the row weights ``(1 - ly, ly)`` rounded to
the value's dtype, the blend accumulated in fp32; then it weights the two
columns ``x0`` and ``x0 + 1`` by ``(1 - lx, lx)`` times the attention
weight, in fp32.  Points are summed in order, then levels in order.  A row
or column outside the grid contributes zero, as in `ms_deform_attn`.

* `ms_deform_attn_v1_plain`: that arithmetic in plain PyTorch, one gather
  per corner.
* `ms_deform_attn_v1_cuda`: the kernel ``csrc/ms_deform_attn_v1.cu``
  (counted, CUDA tensors only, no gradient).  Where `forward_variant`
  says "grouped" it runs kernel 1's gather body (a group of lanes a
  sample, 16-byte loads) with v1's per-sample blend, summing the samples
  in that body's fixed order rather than points then levels; a value off
  a 16-byte boundary is refused there before any launch.  Elsewhere a
  thread a channel.
* `ms_deform_attn_v1`: the plain version for CPU tensors, the kernel for
  CUDA tensors.

The TPU kernel selects rows and columns with one-hot matmuls (its R, E and
G matrices) because the TPU has no fast gather; a GPU reads the texels
directly, so those are not carried over.  Shapes as `ms_deform_attn_cuda`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .cuda_build import CountedKernel
from .ms_deform_attn_cuda import launch_gather_forward


def ms_deform_attn_v1_plain(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    N, S, H, D = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)  # [N,H,Q,L,P,2]
    wts = attention_weights.float().permute(0, 2, 1, 3, 4)  # [N, H, Q, L, P]
    acc = None
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        value_l = value[:, start:start + h * w].permute(0, 2, 1, 3)  # [N,H,hw,D]
        lvl = None
        for p in range(P):
            x = loc[:, :, :, lid, p, 0] * w - 0.5  # [N, H, Q]
            y = loc[:, :, :, lid, p, 1] * h - 0.5
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            lx = x - x0
            ly = y - y0
            x0i = x0.long()
            y0i = y0.long()
            aw = wts[:, :, :, lid, p]
            # v1's row selection: the row weights in the value's dtype
            rows = [(dy, rw.to(value.dtype).float())
                    for dy, rw in ((0, 1.0 - ly), (1, ly))]
            s = 0.0
            for dx, cw in ((0, 1.0 - lx), (1, lx)):
                ix = x0i + dx
                col_ok = (ix >= 0) & (ix < w)
                t = 0.0  # the row blend of this column, fp32
                for dy, rw in rows:
                    iy = y0i + dy
                    ok = col_ok & (iy >= 0) & (iy < h)
                    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
                    texel = torch.gather(
                        value_l, 2, idx[..., None].expand(N, H, Q, D)).float()
                    t = t + torch.where(ok, rw, 0.0)[..., None] * texel
                s = s + torch.where(col_ok, aw * cw, 0.0)[..., None] * t
            lvl = s if lvl is None else lvl + s
        acc = lvl if acc is None else acc + lvl
        start += h * w
    out = acc.permute(0, 2, 1, 3).reshape(N, Q, H * D)
    return out.to(value.dtype)


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the v1 forward kernel; raises on input it does not take."""
    return launch_gather_forward("ms_deform_attn_v1_cuda",
                                 "ms_deform_attn_v1", value, level_shapes,
                                 sampling_locations, attention_weights)


ms_deform_attn_v1_cuda = CountedKernel(_launch)


def ms_deform_attn_v1(value, level_shapes, sampling_locations,
                      attention_weights) -> torch.Tensor:
    """The v1 formulation: the kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns ``[N, Q, H*D]`` in the value's dtype."""
    shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    if value.device.type == "cuda":
        return ms_deform_attn_v1_cuda(value, shapes, sampling_locations,
                                      attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_v1_plain(value, shapes, sampling_locations,
                                       attention_weights)
    raise ValueError(f"ms_deform_attn_v1: unsupported device {value.device}")
