"""Multi-scale deformable attention in plain PyTorch: locations in [0, 1]
over each level's grid (``align_corners=False``), out-of-grid corners
zero, fp32 accumulation."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from einops import rearrange


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value ``[N, S, H, D]``; locations ``[N, Q, H, L, P, 2]`` (x, y);
    weights ``[N, Q, H, L, P]`` -> ``[N, Q, H * D]``."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if sum(h * w for h, w in shapes) != value.shape[1]:
        raise ValueError(f"spatial shapes {shapes} != S={value.shape[1]}")
    N, S, H, D = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    loc32 = sampling_locations.float()
    w32 = attention_weights.float()
    acc = None
    start = 0
    for lid, (h, w) in enumerate(shapes):
        value_l = value[:, start:start + h * w].permute(0, 2, 1, 3)
        x = loc32[:, :, :, lid, :, 0] * w - 0.5
        y = loc32[:, :, :, lid, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        lx = x - x0
        ly = y - y0
        x0i = x0.long()
        y0i = y0.long()
        contrib = None
        for dx, dy, cw in ((0, 0, (1.0 - lx) * (1.0 - ly)),
                           (1, 0, lx * (1.0 - ly)),
                           (0, 1, (1.0 - lx) * ly),
                           (1, 1, lx * ly)):
            ix = x0i + dx
            iy = y0i + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
            idx = idx.permute(0, 2, 1, 3).reshape(N, H, Q * P)
            g = torch.gather(value_l, 2, idx[..., None].expand(N, H, Q * P, D))
            g = g.view(N, H, Q, P, D).permute(0, 2, 1, 3, 4).float()
            cwv = torch.where(valid, cw, torch.zeros_like(cw))
            cwv = cwv * w32[:, :, :, lid, :]
            term = (g * cwv[..., None]).sum(dim=3)
            contrib = term if contrib is None else contrib + term
        acc = contrib if acc is None else acc + contrib
        start += h * w
    return acc.reshape(N, Q, H * D).to(value.dtype)


def ms_deform_attn_multi_image(value, level_shapes, sampling_locations,
                               attention_weights):
    """value ``[B, n_img, hw, H, D]``; locations ``[B, Lq, H, n_img, L, P,
    2]``; weights ``[B, Lq, H, n_img, L, P]`` -> the images' sum ``[B, Lq,
    H * D]``."""
    B = value.shape[0]
    value_f = rearrange(value, "b n s h d -> (b n) s h d")
    loc_f = rearrange(sampling_locations, "b q h n l p t -> (b n) q h l p t")
    w_f = rearrange(attention_weights, "b q h n l p -> (b n) q h l p")
    out = ms_deform_attn(value_f, level_shapes, loc_f, w_f)
    out = rearrange(out, "(b n) q c -> b n q c", b=B)
    return out.sum(dim=1)
