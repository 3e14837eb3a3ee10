"""The flash-attention kernels, forward and backward, and their plain
version (counterpart of `mm_interleaved_tpu/ops/flash_attention.py`).

* `flash_attention` launches ``csrc/flash_attention.cu`` on PyTorch's
  current stream; with ``return_lse`` it also returns, for the backward,
  the fp32 log-sum-exp ``[B, H, Tq]`` of each row.
  `flash_attention_bwd` launches ``csrc/flash_attention_bwd.cu`` (the dQ
  kernel, which also takes each row's delta, then the dK/dV kernel) on
  q, k, v, the output's gradient and the LSE, and returns ``(dq, dk,
  dv)``.  ``.launches`` counts each
  wrapper's launches.  They take CUDA tensors only, ``D <= 128`` and a
  multiple of 8, and no dense mask, and raise on anything else.  In bf16
  at ``D`` 64 and 128 (every call of the flagship) they launch the Hopper
  kernels (wgmma products, TMA loads through an mbarrier ring), which need
  16-byte aligned, contiguous ``[B, T, H, D]`` inputs: `_check_tma`
  refuses anything else before a launch, with no fallback.
* `FlashAttentionFunction` is the differentiable op on the card: the
  forward kernel (with the LSE when autograd records the call) and the
  backward kernels.  The bare forward wrapper refuses a recorded call.
* `attention_plain` is the same function in plain PyTorch (fp32 logits
  and softmax, masked logits at the lowest finite fp32 value), with a dense
  ``mask`` besides.  The CPU path, the masked calls and the tests use it,
  and autograd differentiates it (`attention_plain_backward`); on the card
  both are the reference the kernels are held against.

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
TMA_HEAD_DIMS = (64, 128)  # bf16 head dims of the wgmma + TMA kernels


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


def attention_plain_backward(q, k, v, grad_out, **kw):
    """``(dq, dk, dv)`` of `attention_plain` by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_plain(*ins, **kw)
        return torch.autograd.grad(out, ins, grad_out)


def _check(name, q, k, v, q_segment_ids, kv_segment_ids):
    """The inputs every kernel of the op takes; returns ``(B, Tq, Tk, H,
    D)`` and the segment ids as contiguous int32 (or Nones)."""
    check_cuda(name, (q, k, v))
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
    return (B, Tq, Tk, H, D), segs


def _check_tma(name, *tensors):
    """What the Hopper kernels' TMA loads need of bf16 inputs at head dim 64
    or 128 (other inputs take kernels without TMA): a 16-byte aligned base,
    contiguous ``[B, T, H, D]`` rows with strides of whole 16-byte units.
    Raises before any launch; there is no fallback."""
    q = tensors[0]
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TMA_HEAD_DIMS:
        return
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the TMA kernels need 16-byte aligned "
                             f"inputs (base at {t.data_ptr()} % 16 = "
                             f"{t.data_ptr() % 16})")
        if any(s * t.element_size() % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: the TMA kernels need row strides in "
                             f"16-byte units (strides {t.stride()})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the TMA kernels need contiguous "
                             f"[B, T, H, D] inputs (strides {t.stride()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(q, k, v, *, causal=False, scale=None, q_segment_ids=None,
            kv_segment_ids=None, return_lse=False):
    """Launch the forward kernel; raises on input it does not take.
    Returns ``out``, or ``(out, lse)`` with ``return_lse``."""
    name = "flash_attention"
    _check_tma(name, q, k, v)
    (B, Tq, Tk, H, D), segs = _check(name, q, k, v, q_segment_ids,
                                     kv_segment_ids)
    forbid_grad(name, q, k, v)
    scale = D ** -0.5 if scale is None else float(scale)
    fn = load_library("flash_attention").mmi_flash_attention_fwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(q.device.index, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), _ptr(segs[0]), _ptr(segs[1]),
             _ptr(lse), B, Tq, Tk, H, D, scale, int(causal), stream_of(q))
    raise_on_error(name, err)
    return (out, lse) if return_lse else out


def _launch_bwd(q, k, v, grad_out, lse, *, causal=False, scale=None,
                q_segment_ids=None, kv_segment_ids=None):
    """Launch the backward kernels on the forward's LSE; returns ``(dq, dk,
    dv)`` in q's dtype."""
    name = "flash_attention_bwd"
    _check_tma(name, q, k, v, grad_out)
    (B, Tq, Tk, H, D), segs = _check(name, q, k, v, q_segment_ids,
                                     kv_segment_ids)
    check_cuda(name, (q, grad_out), dtypes=(q.dtype,))
    if grad_out.shape != q.shape:
        raise ValueError(f"{name}: grad {tuple(grad_out.shape)} != q "
                         f"{tuple(q.shape)}")
    check_cuda(name, (lse, q), dtypes=(torch.float32,))
    if lse.shape != (B, H, Tq):
        raise ValueError(f"{name}: lse {tuple(lse.shape)} != {(B, H, Tq)}")
    scale = D ** -0.5 if scale is None else float(scale)
    fn = load_library("flash_attention_bwd").mmi_flash_attention_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    err = fn(q.device.index, _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
             v.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _ptr(segs[0]), _ptr(segs[1]), B, Tq, Tk, H, D, scale, int(causal),
             stream_of(q))
    raise_on_error(name, err)
    return dq, dk, dv


flash_attention = CountedKernel(_launch)
flash_attention_bwd = CountedKernel(_launch_bwd)


class FlashAttentionFunction(torch.autograd.Function):
    """The attention op on the card: the forward kernel, keeping the LSE
    when ``keep_lse`` (autograd records the call), and the backward
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_segment_ids, kv_segment_ids,
                keep_lse):
        kw = dict(causal=causal, scale=scale, q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids)
        if not keep_lse:
            return flash_attention(q, k, v, **kw)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, grad_out.contiguous(), lse,
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
