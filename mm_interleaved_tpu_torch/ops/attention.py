"""Scaled dot-product attention with fp32 logits and softmax (counterpart of
`mm_interleaved_tpu/ops/attention.py`).

Dispatch, by device and mask: a CUDA call without a dense ``mask`` launches
the hand-written flash kernel of `flash_attention` (causal and segment ids
included, any lengths, ``D <= 128``; a wider head raises).  The TPU's shape
gates (Tq >= 256, 128-aligned lengths) have no counterpart.  Calls with a
dense mask (the KV-cache prefill and decode, the image decoder's masked
cross-attention) and every CPU call take the plain version,
`flash_attention.attention_plain`, as they take the XLA path in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa


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
    kw = dict(causal=causal, scale=scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)
    if q.device.type == "cuda" and mask is None:
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)
    return _fa.attention_plain(q, k, v, mask=mask, **kw)
