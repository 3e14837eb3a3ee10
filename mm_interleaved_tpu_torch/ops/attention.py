"""Scaled dot-product attention with fp32 logits and softmax (counterpart
of the plain path of `mm_interleaved_tpu/ops/attention.py`, `_xla_attention`).

The JAX package sends cache-free, mask-free calls with aligned lengths to a
Pallas flash kernel; none of those calls is on the text-generation path,
so this module holds the plain math only.
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention.

    Args:
      q: ``[B, Tq, H, D]``; k, v: ``[B, Tk, H, D]``.
      mask: boolean mask broadcastable to ``[B, H, Tq, Tk]``, True = attend.
      causal: query i attends keys <= i, aligned to the end of the keys.
      q_segment_ids / kv_segment_ids: ``[B, Tq]`` / ``[B, Tk]``; attention
        only within equal segments.
    """
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    neg = torch.finfo(torch.float32).min
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, neg)
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        logits = logits.masked_fill(~seg[:, None], neg)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)

    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype), v)
