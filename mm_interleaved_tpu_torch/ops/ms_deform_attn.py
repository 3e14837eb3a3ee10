"""Multi-scale deformable attention (counterpart of
`mm_interleaved_tpu/ops/ms_deform_attn.py`).

Semantics: sampling locations are normalised to [0, 1] over each level's
grid with the ``align_corners=False`` convention (texel ``(i, j)`` has its
centre at ``((j + 0.5)/W, (i + 0.5)/H)``), out-of-bounds corners contribute
zero, and accumulation is fp32 whatever the input dtype.

Dispatch is by device alone: a CUDA tensor always launches the hand-written
kernel of `ms_deform_attn_cuda` (decode's one-query calls included: a gather
has no small-Q problem, so the JAX package's one-hot path has no
counterpart here); a CPU tensor runs that module's plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from einops import rearrange

from . import ms_deform_attn_cuda as _k


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Multi-scale deformable attention core.

    Args:
      value: ``[B, S, n_heads, D]`` with ``S == sum(H_l * W_l)``.
      spatial_shapes: static ``[(H_0, W_0), ...]`` in concatenation order.
      sampling_locations: ``[B, Lq, n_heads, L, P, 2]`` in [0, 1], (x, y).
      attention_weights: ``[B, Lq, n_heads, L, P]``.

    Returns:
      ``[B, Lq, n_heads * D]`` in the dtype of ``value``.
    """
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if sampling_locations.shape[3] != len(shapes):
        raise ValueError(
            f"sampling_locations has {sampling_locations.shape[3]} levels, "
            f"spatial_shapes has {len(shapes)}"
        )
    if sum(h * w for h, w in shapes) != value.shape[1]:
        raise ValueError(f"spatial shapes {shapes} != S={value.shape[1]}")
    if value.device.type == "cuda":
        return _k.ms_deform_attn_cuda(
            value, shapes, sampling_locations, attention_weights
        )
    if value.device.type == "cpu":
        return _k.ms_deform_attn_plain(
            value, shapes, sampling_locations, attention_weights
        )
    raise ValueError(f"ms_deform_attn: unsupported device {value.device}")


def ms_deform_attn_multi_image(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Multi-image variant used by MMFS: the image axis folds into the batch
    (one gather per unique level) and image contributions are summed after,
    which is exact because the output is linear in the weights.

    Args:
      value: ``[B, n_img, hw, n_heads, D]``.
      sampling_locations: ``[B, Lq, n_heads, n_img, n_levels, P, 2]``.
      attention_weights: ``[B, Lq, n_heads, n_img, n_levels, P]``.

    Returns:
      ``[B, Lq, n_heads * D]``.
    """
    B = value.shape[0]
    value_f = rearrange(value, "b n s h d -> (b n) s h d")
    loc_f = rearrange(sampling_locations, "b q h n l p t -> (b n) q h l p t")
    w_f = rearrange(attention_weights, "b q h n l p -> (b n) q h l p")
    out = ms_deform_attn(value_f, level_shapes, loc_f.contiguous(),
                         w_f.contiguous())
    out = rearrange(out, "(b n) q c -> b n q c", b=B)
    return out.sum(dim=1)
