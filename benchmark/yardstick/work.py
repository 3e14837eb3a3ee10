"""Operations and bytes of each of the program's CUDA kernels at a call's
shapes, frozen from the arithmetic of the program's on-card check
(`chip_smoke.py`'s ``work_*`` functions and `bench_unet_kernels`'s).

Each function takes the arguments of the kernel's launch wrapper (the
`CountedKernel`'s ``_launch``) and its output, and returns ``(flops,
bytes, peak)``.  Counts that depend on the data (the causal or segment
pairs, the live images) may come back as 0-d device tensors, so that no
call waits for the device while it is traced; the caller reads them
after the traced window.  Bytes count each input read once and each
output written once."""

from __future__ import annotations

import torch

from .peaks import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS


def _nbytes(*ts) -> int:
    n = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif hasattr(t, "element_size"):
            n += t.numel() * t.element_size()
    return n


def _rate(t: torch.Tensor) -> float:
    return PEAK_BF16_FLOPS if t.dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def deform_fwd(args, kw, out):
    """Kernel 1: the value texels the samples can touch (4 corners of D
    channels a sample, at most the whole value), the locations, weights
    and output; 8 operations a sample and channel (fp32)."""
    value, shapes, loc, w = args[:4]
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return 8 * samples * D, touched + _nbytes(loc, w, out), PEAK_FP32_FLOPS


def flash_fwd(args, kw, out):
    """Kernel 5: 4 operations per unmasked (query, key) pair, head and
    channel at the bf16 rate; q, k, v and the output once."""
    q, k, v = args[:3]
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    pairs = B * Tq * Tk
    causal = kw.get("causal", args[3] if len(args) > 3 else False)
    q_seg = kw.get("q_segment_ids")
    kv_seg = kw.get("kv_segment_ids")
    if causal or q_seg is not None:
        dev = q_seg.device if q_seg is not None else "cpu"
        ok = torch.ones((B, Tq, Tk), dtype=torch.bool, device=dev)
        if causal:
            qi = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
            ok &= (torch.arange(Tk, device=dev)[None, :] <= qi)[None]
        if q_seg is not None:
            ok &= q_seg[:, :, None] == kv_seg[:, None, :]
        pairs = ok.sum()
    return 4 * pairs * H * D, _nbytes(q, k, v, out), PEAK_BF16_FLOPS


def mi_fwd(args, kw, out):
    """Kernel 4: 8 fp32 operations per live sample and channel; the value
    texels the samples can touch (at most the live images), the
    query-side tables and the output once."""
    value, delta, shapes, ref, off_q, wq = args[:6]
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(shapes)
    live = (delta.reshape(Bv, H, n_img, L * P, 3)[..., 2] != 0).any(-1)
    live_bhn = int(live.sum())
    samples = live_bhn * (B // Bv) * Lq * L * P
    touched = min(live_bhn * S * D, 4 * samples * D) * value.element_size()
    return (8 * samples * D,
            touched + _nbytes(delta, ref, off_q, wq, out), PEAK_FP32_FLOPS)


def geglu_fwd(args, kw, out):
    """Kernel 7: 6 T C F tensor-core operations; x, the weights and the
    output once."""
    x, w1, b1, w2, b2 = args[:5]
    C = x.shape[-1]
    return (6 * (x.numel() // C) * C * w2.shape[1],
            _nbytes(x, w1, b1, w2, b2, out), PEAK_BF16_FLOPS)


def gn_moments(args, kw, out):
    """Kernel 6, moments: x read once, the folded scale and offset
    written; 3 fp32 operations an element."""
    x, scale, bias = args[:3]
    return 3 * x.numel(), _nbytes(x, scale, bias, out), PEAK_FP32_FLOPS


def gn_apply(args, kw, out):
    """Kernel 6, apply: x and the folded scale and offset read, y written;
    3 fp32 operations an element (the multiply-add, the silu)."""
    x, wb = args[:2]
    return 3 * x.numel(), _nbytes(x, wb, out), PEAK_FP32_FLOPS


def int8_linear(args, kw, out):
    """Kernel Q: x, the codes, the scales, the bias and the output once;
    2 M N K operations at the rate of x's dtype."""
    x, q, scale = args[:3]
    bias = args[3] if len(args) > 3 else kw.get("bias")
    K = x.shape[-1]
    M = x.numel() // K
    N = q.shape[0]
    nbytes = _nbytes(x, q, scale, bias) + M * N * x.element_size()
    return 2 * M * N * K, nbytes, _rate(x)


def deform_bwd_value(args, kw, out):
    """Kernel 2: dOut, the locations and weights read, the value gradient
    written once; 8 operations a sample and channel."""
    value, shapes, loc, w, grad_out = args[:5]
    N, Q, H, L, P, _ = loc.shape
    samples = N * Q * H * L * P
    return (8 * samples * value.shape[3],
            _nbytes(grad_out, loc, w, value), PEAK_FP32_FLOPS)


def deform_bwd_loc_weight(args, kw, out):
    """Kernel 3: the corners the samples can touch, dOut, the locations
    and weights read, their gradients written; 8 operations a sample and
    channel."""
    value, shapes, loc, w, grad_out = args[:5]
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return (8 * samples * D, touched + _nbytes(grad_out, loc, w, out),
            PEAK_FP32_FLOPS)


def flash_bwd(args, kw, out):
    """Kernel 5b: 10 operations per unmasked pair, head and channel; q, k,
    v, dOut and the LSE read, dq, dk, dv written."""
    q, k, v, grad_out, lse = args[:5]
    flops, _, rate = flash_fwd((q, k, v), kw, q)
    return flops // 4 * 10, _nbytes(q, k, v, grad_out, lse, out), rate


# by the name of the program's `CountedKernel` object (its attribute in
# the op's module)
WORK = {
    "ms_deform_attn_cuda": deform_fwd,
    "ms_deform_attn_mi_cuda": mi_fwd,
    "flash_attention": flash_fwd,
    "geglu_cuda": geglu_fwd,
    "group_norm_moments_cuda": gn_moments,
    "group_norm_apply_cuda": gn_apply,
    "int8_linear_cuda": int8_linear,
    "ms_deform_attn_bwd_value_cuda": deform_bwd_value,
    "ms_deform_attn_bwd_loc_weight_cuda": deform_bwd_loc_weight,
    "flash_attention_bwd": flash_bwd,
}

# the arguments (by position or keyword) whose values a count reads
BY_VALUE = {
    "flash_attention": ("q_segment_ids", "kv_segment_ids"),
    "flash_attention_bwd": ("q_segment_ids", "kv_segment_ids"),
    "ms_deform_attn_mi_cuda": (1,),
}
