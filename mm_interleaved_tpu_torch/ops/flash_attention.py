"""The flash-attention forward kernel and its plain version (counterpart of
`mm_interleaved_tpu/ops/flash_attention.py`, forward only).

* `flash_attention` launches ``csrc/flash_attention.cu`` on PyTorch's
  current stream; ``flash_attention.launches`` counts its launches.  It
  takes CUDA tensors only, ``D <= 128`` and a multiple of 8, and no dense
  mask, and raises on anything else.
* `attention_plain` is the same function in plain PyTorch (fp32 logits
  and softmax, masked logits at the lowest finite fp32 value), with a dense
  ``mask`` besides.  The CPU path, the masked calls and the tests use it; on
  the card it is the reference the kernel is held against.

Both take ``q [B, Tq, H, D]``, ``k, v [B, Tk, H, D]`` and return
``[B, Tq, H, D]`` in q's dtype.  ``causal`` aligns the mask to the end of
the keys; ``q_segment_ids [B, Tq]`` / ``kv_segment_ids [B, Tk]`` allow
attention within equal segments only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def attention_plain(
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
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
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


def _launch(q, k, v, *, causal=False, scale=None, q_segment_ids=None,
            kv_segment_ids=None):
    """Launch the CUDA kernel; raises on input it does not take."""
    name = "flash_attention"
    check_cuda(name, (q, k, v))
    forbid_grad(name, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"{name}: head dim {D} (needs <= {MAX_HEAD_DIM}, a "
                         "multiple of 8)")
    if Tk < 1:
        raise ValueError(f"{name}: no keys")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError(f"{name}: give both segment ids or neither")
    segs = (None, None)
    if q_segment_ids is not None:
        segs = (q_segment_ids.to(torch.int32).contiguous(),
                kv_segment_ids.to(torch.int32).contiguous())
        if segs[0].shape != (B, Tq) or segs[1].shape != (B, Tk):
            raise ValueError(f"{name}: segment ids {tuple(segs[0].shape)}, "
                             f"{tuple(segs[1].shape)}")
        check_cuda(name, (q,) + segs, dtypes=(q.dtype,))
    scale = D ** -0.5 if scale is None else float(scale)

    fn = load_library("flash_attention").mmi_flash_attention_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    err = fn(q.device.index, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(),
             None if segs[0] is None else segs[0].data_ptr(),
             None if segs[1] is None else segs[1].data_ptr(),
             B, Tq, Tk, H, D, scale, int(causal), stream_of(q))
    raise_on_error(name, err)
    return out


flash_attention = CountedKernel(_launch)
