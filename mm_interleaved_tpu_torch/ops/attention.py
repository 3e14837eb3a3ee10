"""Scaled dot-product attention with fp32 logits and softmax (counterpart of
`mm_interleaved_tpu/ops/attention.py`).

Dispatch, by device and mask: a CUDA call without a dense ``mask`` goes
through `flash_attention.FlashAttentionFunction`, the hand-written flash
kernels (causal and segment ids included, any lengths, ``D <= 128``; a
wider head raises), forward and, when autograd records the call, backward.
The TPU's shape gates (Tq >= 256, 128-aligned lengths) have no
counterpart.  Calls with a dense mask (the KV-cache prefill and decode, the
image decoder's masked cross-attention) and every CPU call take the plain
version, `flash_attention.attention_plain`, which autograd differentiates,
as they take the XLA path in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from .cuda_build import needs_grad


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention.

    Args:
      q: ``[B, Tq, H, D]``; k, v: ``[B, Tk, H, D]``.
      mask: boolean mask broadcastable to ``[B, H, Tq, Tk]``, True = attend.
      causal: query i attends keys <= i, aligned to the end of the keys.
      scale: overrides the default ``1/sqrt(D)``.
      q_segment_ids / kv_segment_ids: ``[B, Tq]`` / ``[B, Tk]``; attention
        only within equal segments.
    """
    if q.device.type == "cuda" and mask is None:
        return _fa.FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), causal, scale,
            q_segment_ids, kv_segment_ids, needs_grad(q, k, v))
    return _fa.attention_plain(q, k, v, mask=mask, causal=causal, scale=scale,
                               q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids)
