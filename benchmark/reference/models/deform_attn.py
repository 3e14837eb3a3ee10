"""Single-image multi-scale deformable attention, Deformable-DETR style
(counterpart of `mm_interleaved_tpu/models/deform_attn.py`), used by the
ViT-Adapter's Injector and Extractor blocks.  Cut over ``tensor``
(`parallel.tensor`), it holds this rank's heads: ``value_proj``'s columns,
the head-major rows of ``sampling_offsets`` and ``attention_weights``, and
``output_proj``'s input columns, whose partial output is summed over
``tensor_group`` before the bias."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.ms_deform_attn import ms_deform_attn
from ..parallel.tensor import row_parallel, tensor_enter


def grid_reference_points(
    level_shapes: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Pixel-centre reference points of every location of every level,
    normalised to [0, 1]: ``[sum(H*W), 2]`` in (x, y) order."""
    pts = []
    for h, w in level_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
    return np.concatenate(pts, axis=0)


def radial_offset_bias(n_heads: int, n_levels: int,
                       n_points: int) -> np.ndarray:
    """Deformable-DETR offset bias: head h points in direction 2*pi*h/H,
    point p at radius p+1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    """Deformable attention over one image's level pyramid."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_points: int = 4, ratio: float = 1.0,
                 level_shapes: Sequence[Tuple[int, int]] = ((16, 16),)):
        super().__init__()
        self.n_points = n_points
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        L = len(self.level_shapes)
        d_val = int(d_model * ratio)
        self.value_proj = nn.Linear(d_model, d_val)
        self.sampling_offsets = nn.Linear(d_model, n_heads * L * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * L * n_points)
        self.output_proj = nn.Linear(d_val, d_model)
        self.tensor_group = None

    @property
    def n_heads(self) -> int:
        """The heads this module holds (all, or this rank's)."""
        return self.attention_weights.out_features // (
            len(self.level_shapes) * self.n_points)

    def tensor_pairs(self):
        return (("tensor_group", self.n_heads,
                 ("value_proj", "sampling_offsets", "attention_weights",
                  "output_proj")),)

    def init_weights(self, g: torch.Generator) -> None:
        L = len(self.level_shapes)
        self.sampling_offsets.weight.data.zero_()
        self.sampling_offsets.bias.data.copy_(torch.from_numpy(
            radial_offset_bias(self.n_heads, L, self.n_points)
        ))
        self.attention_weights.weight.data.zero_()
        self.attention_weights.bias.data.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                feat: torch.Tensor) -> torch.Tensor:
        """query [B, Lq, C], reference_points [B or 1, Lq, 2] in [0, 1],
        feat [B, sum(H*W), C]."""
        L = len(self.level_shapes)
        P = self.n_points
        nh = self.n_heads
        B, Lq, _ = query.shape
        group = self.tensor_group
        query = tensor_enter(query, group)
        value = self.value_proj(tensor_enter(feat, group))
        value = value.view(B, value.shape[1], nh, -1)
        offsets = self.sampling_offsets(query).view(B, Lq, nh, L, P, 2)
        logits = self.attention_weights(query).view(B, Lq, nh, L * P)
        weights = torch.softmax(logits.float(), dim=-1).view(B, Lq, nh, L, P)

        normalizer = torch.tensor(
            [[w, h] for (h, w) in self.level_shapes], dtype=torch.float32,
            device=query.device,
        )
        ref = reference_points.float().expand(B, Lq, 2)
        locations = (
            ref[:, :, None, None, None, :]
            + offsets.float() / normalizer[None, None, None, :, None, :]
        )
        # locations and weights travel in the value dtype, as in the JAX
        # module (bf16 on the card)
        out = ms_deform_attn(
            value,
            self.level_shapes,
            locations.to(value.dtype).contiguous(),
            weights.to(value.dtype).contiguous(),
        )
        return row_parallel(self.output_proj, out, group)
