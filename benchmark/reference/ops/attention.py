"""Attention in plain PyTorch: fp32 logits and softmax, computed in blocks
of queries so that long sequences fit (exact: each query's softmax is
whole over its keys)."""

from __future__ import annotations

from typing import Optional

import torch

# the most (batch x heads x queries x keys) logits held at once
MAX_LOGITS = 1 << 28


def _block(q, k, v, mask, causal, scale, q_seg, kv_seg, q0):
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qi = torch.arange(tq, device=q.device)[:, None] + q0
        ki = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, neg)
    if q_seg is not None:
        seg = q_seg[:, :, None] == kv_seg[:, None, :]
        logits = logits.masked_fill(~seg[:, None], neg)
    if mask is not None:
        logits = logits.masked_fill(~mask, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


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
    """q ``[B, Tq, H, D]``; k, v ``[B, Tk, H, D]``; ``mask`` boolean,
    broadcastable to ``[B, H, Tq, Tk]``, True = attend; ``causal`` aligned
    to the end of the keys; segment ids ``[B, Tq]`` / ``[B, Tk]``."""
    B, Tq, H, _ = q.shape
    Tk = k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    step = max(1, MAX_LOGITS // max(1, B * H * Tk))
    outs = []
    for s in range(0, Tq, step):
        e = min(Tq, s + step)
        m = None
        if mask is not None:
            m = mask
            if m.shape[-2] == Tq and Tq > 1:
                m = m[..., s:e, :]
        outs.append(_block(
            q[:, s:e], k, v, m, causal, scale,
            None if q_segment_ids is None else q_segment_ids[:, s:e],
            kv_segment_ids, s + (Tk - Tq)))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
