"""The UNet's kernels at the flagship's call sites, in a process of their
own: the multi-image MMFS readout (kernel 4, `ops/ms_deform_attn_mi.py`),
the fused GEGLU feed-forward (kernel 7, `ops/geglu.py`), GroupNorm and
GroupNorm+SiLU (`ops/group_norm.py`), and the deformable kernels of
`ops/ms_deform_attn_cuda.py` in the training step: the forward (kernel 1,
``deform_fwd``), the value gradient (kernel 2, ``deform_value``) and the
location/weight gradient (kernel 3, ``deform_bwd``).

    python -m mm_interleaved_tpu_torch.bench_unet_kernels            # card
    python -m mm_interleaved_tpu_torch.bench_unet_kernels --sites DIR
    python -m mm_interleaved_tpu_torch.bench_unet_kernels --kernels gn deform_bwd
    python -m mm_interleaved_tpu_torch.bench_unet_kernels \
        --kernels deform_fwd deform_value deform_bwd
    python -m mm_interleaved_tpu_torch.bench_unet_kernels --device cpu

The sites are the ones `chip_smoke.py` captures on the flagship's paths:
GEGLU at C = 320 (x [32768, 320]) and C = 640 ([8192, 640]); the MMFS
readout at 64, 32, 16 and 8 px (value [4, 1, 5440, 16, 64] in bf16, the
queries of both CFG halves, 4 levels x 8 points, two of the four image rows
masked), plus ``mi_uniform_64px``, the 64 px site with its locations drawn
uniformly over [-0.1, 1.1] (every corner a random read); GroupNorm+SiLU at
the UNet's ResnetBlock inputs at 64 / 32 / 16 / 8 px (x [8, px, px, C] in
bf16), the VAE decoder's 512 px site ([4, 512, 512, 128] bf16) and the
fp32 VAE encode's ([4, 512, 512, 128] fp32, training), and GroupNorm at
the UNet's SpatialTransformer inputs (``gn``); kernels 1, 2 and 3 at the
training step's UNet MMFS sites, 64 and 32 px (value [4, 5440, 16, 64]
bf16, 4096 / 1024 queries, 4 levels x 8 points, offsets of about 2 texels
of level 0), and kernel 1 also at the LLM's one-query MMFS decode
(``mmfs_decode``: value [4, 1344, 16, 64] bf16, levels 32, 16, 8 px, 8
points).  By default their inputs are drawn from a numpy
``RandomState(0)`` at those shapes; ``--sites`` reads the inputs
`chip_smoke.py` captured instead (its phases 7 and 8 save them under
``build/sites/``, a file a kernel), where it has them.

Each kernel, as its public entry calls it (the variant the wrapper picks
by shape, logged as ``variant``; kernel 2's plan as ``plan``), is held
against the plain version (bf16: one ulp at the output's scale; kernels 2
and 3 two, as phase 8c holds them; kernels 1, 2 and 3 also bit-identical
over two calls) and timed three ways: ``ms``, the median of 25 synchronised CUDA-event runs;
``device_ms``, the mean device time of 10 calls under `torch.profiler`
(None where the profiler dropped records); ``queued_ms``, the mean of 25
calls enqueued back to back; ``launches``, the kernels a call launches
(from the profiler); GroupNorm's apply kernel is also timed after an
L2 flush (``apply_cold_l2_ms``, beside its time in the op in
``by_kernel``).  GEGLU also gets ``unfused_ms``: two `F.linear` calls
around a plain GEGLU, the path of the C = 1280 blocks, as a yardstick (the
port never calls it at these widths).  The MMFS sites also log the spread
of their sampling offsets in texels per level.  The card's ``nvidia-smi``
name and power line, then one JSON row per (kernel, site).

The module needs only the public entries it times, their plain versions
and `utils/timing.py`, so copied into an older checkout of the package it
measures that checkout's code on the same inputs: before and after in one
call (GroupNorm through `group_norm_silu` / `group_norm`, whatever they
launch there).  ``--device cpu`` runs the plain versions at a tiny size
and times nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import geglu as geglu_ops
from .ops import group_norm as gn_ops
from .ops import ms_deform_attn_cuda as deform_ops
from .ops import ms_deform_attn_mi as mi_ops
from .utils.timing import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS,
                           device_kernels, device_ms, queued_ms, time_ms)
from .utils.timing import nbytes as _nbytes

SEED = 0
LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))
GEGLU = {"C320": (8 * 4096, 320), "C640": (8 * 1024, 640)}
MI_SITES = {"unet_64px": 4096, "unet_32px": 1024, "unet_16px": 256,
            "unet_8px": 64}
# GroupNorm sites: (B, px, C, groups, eps, silu, dtype)
GN = {
    "unet_64px_c320": (8, 64, 320, 32, 1e-5, True, torch.bfloat16),
    "unet_32px_c640": (8, 32, 640, 32, 1e-5, True, torch.bfloat16),
    "unet_16px_c1280": (8, 16, 1280, 32, 1e-5, True, torch.bfloat16),
    "unet_8px_c1280": (8, 8, 1280, 32, 1e-5, True, torch.bfloat16),
    "unet_attn_64px_c320": (8, 64, 320, 32, 1e-6, False, torch.bfloat16),
    "unet_attn_32px_c640": (8, 32, 640, 32, 1e-6, False, torch.bfloat16),
    "vae_512px_c128": (4, 512, 128, 32, 1e-6, True, torch.bfloat16),
    "vae_enc_512px_c128_fp32": (4, 512, 128, 32, 1e-6, True, torch.float32),
}
DEFORM_BWD = {"unet_64px": 4096, "unet_32px": 1024}
# the LLM's MMFS at decode: one query, its levels, points and batch
DECODE = dict(shapes=((32, 32), (16, 16), (8, 8)), N=4, H=16, D=64, P=8)
TINY_GEGLU = {"C64": (40, 64)}
TINY_MI = {"tiny_16px": 256}
TINY_GN = {"tiny_8px_c32": (2, 8, 32, 4, 1e-5, True, torch.float32)}
TINY_DEFORM_BWD = {"tiny_8px": 64}


# --------------------------------------------------------------------------
# inputs


def geglu_inputs(T: int, C: int, rng, device, dtype=torch.bfloat16):
    """x [T, C], w1 [8C, C], b1, w2 [C, 4C], b2 at the UNet block's
    scales."""
    Fh = 4 * C

    def dev(a, scale=1.0):
        return torch.from_numpy((a * scale).astype(np.float32)).to(
            device=device, dtype=dtype)

    return (dev(rng.randn(T, C)), dev(rng.randn(2 * Fh, C), C ** -0.5),
            dev(rng.randn(2 * Fh), 0.1), dev(rng.randn(C, Fh), Fh ** -0.5),
            dev(rng.randn(C), 0.1))


def gn_inputs(B, px, C, groups, eps, silu, dtype, rng, device):
    """``(x, scale, bias, groups, eps, silu)`` of a GroupNorm site: x
    [B, px, px, C] with a per-channel mean (the input of a norm is a
    residual stream), scale and bias in bf16 as the model keeps them."""
    x = rng.randn(B, px, px, C) + rng.randn(C) * 0.5
    t = lambda a, dt: torch.from_numpy(a.astype(np.float32)).to(
        device=device, dtype=dt)
    return (t(x, dtype), t(1 + 0.1 * rng.randn(C), torch.bfloat16),
            t(0.1 * rng.randn(C), torch.bfloat16), groups, eps, silu)


def deform_bwd_inputs(Q, rng, device, shapes=LEVELS, N=4, H=16, D=64, P=8,
                      dtype=torch.bfloat16):
    """``(value, shapes, loc, w, grad_out)`` of kernel 3 at a UNet MMFS
    training site: queries on a square grid, each point offset by about 2
    texels of level 0 from its query, the same on every level."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    ref = grid_ref(Q)[None, :, None, None, None, :]
    off = rng.randn(N, Q, H, L, P, 2) * 2 / shapes[0][1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(
        np.float32)).to(device=device, dtype=dtype)
    return (t(rng.randn(N, S, H, D)), shapes, t(ref + off),
            t(rng.rand(N, Q, H, L, P) / (L * P)),
            t(rng.randn(N, Q, H * D)))


def grid_ref(Lq: int) -> np.ndarray:
    """Row-major pixel centres, [Lq, 2] (x, y), of a grid ceil(sqrt(Lq))
    wide (square where Lq is)."""
    W = int(np.ceil(Lq ** 0.5))
    i = np.arange(Lq)
    return np.stack([(i % W + 0.5) / W, (i // W + 0.5) / -(-Lq // W)],
                    -1).astype(np.float32)


def mi_inputs(Lq: int, rng, device, uniform=False, shapes=LEVELS, Bv=4,
              B=8, n_img=1, H=16, D=64, P=8, live=(1, 3), inv_base=1 / 64,
              masked=False, dtype=torch.bfloat16):
    """The positional arguments of `mmfs_deform_factorized` at a UNet
    site: image rows outside ``live`` masked through their weight factor
    (with ``masked``, also image 1 of row 0 for heads 0-7 alone); offsets
    of about 2 texels of level 0 (query side) and 1 (image side); with
    ``uniform``, locations uniform over [-0.1, 1.1] instead."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(Bv, n_img, S, H, D).astype(np.float32)
    off_img = rng.randn(Bv, n_img, H, P, 2).astype(np.float32)
    wi = rng.rand(Bv, n_img, H, L, P).astype(np.float32)
    wi[[b for b in range(Bv) if b not in live]] = 0.0
    if masked:
        wi[0, 1, :8] = 0.0
    ref = np.broadcast_to(grid_ref(Lq), (B, Lq, 2)).copy()
    off_q = (rng.randn(B, Lq, H, P, 2) * 2).astype(np.float32)
    wq = (rng.rand(B, Lq, H, L, P) / (L * P)).astype(np.float32)
    if uniform:
        off_img[:] = 0.0
        u = rng.rand(B, Lq, H, P, 2).astype(np.float32) * 1.2 - 0.1
        off_q = (u - ref[:, :, None, None, :]) / inv_base
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    delta = mi_ops.build_delta(t(off_img), t(wi), shapes, inv_base)
    return (t(value).to(dtype), delta, shapes, t(ref), t(off_q),
            t(wq).to(dtype), inv_base)


def offset_spread(args) -> dict:
    """How far the samples of an MMFS call land from their reference
    point, in texels of each level: per level, the median, 90th
    percentile and largest of max(|dx|, |dy|) over the live samples
    (image weight factor not zero)."""
    value, delta, shapes, ref, off_q, wq, inv_base = args
    Bv, n_img, _, H, _ = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(shapes)
    dl = delta.float().reshape(Bv, H, n_img, L, P, 3)
    dl = dl[torch.arange(B, device=dl.device) % Bv]  # [B, H, n, L, P, 3]
    out = {}
    for lid, (hl, wl) in enumerate(shapes):
        dq = off_q.float() * inv_base  # [B, Lq, H, P, 2]
        dx = dq[..., 0][:, :, :, None] * wl + dl[:, None, :, :, lid, :, 0]
        dy = dq[..., 1][:, :, :, None] * hl + dl[:, None, :, :, lid, :, 1]
        live = (dl[:, None, :, :, lid, :, 2] != 0).expand_as(dx)
        d = torch.maximum(dx.abs(), dy.abs())[live]
        if d.numel() == 0:
            out[f"level{lid}_{hl}x{wl}"] = None
            continue
        if d.numel() > 2 ** 24:  # quantile's limit
            d = d[torch.randperm(d.numel(), device=d.device)[:2 ** 24]]
        q = torch.quantile(d, torch.tensor([0.5, 0.9], device=d.device))
        out[f"level{lid}_{hl}x{wl}"] = dict(p50=float(q[0]), p90=float(q[1]),
                                            max=float(d.max()))
    return out


# --------------------------------------------------------------------------
# work and timing


def geglu_work(args, out):
    """(flops, bytes, peak): 6 T C F tensor-core flops; x, the weights and
    the output moved once."""
    x, w1, b1, w2, b2 = args
    C = x.shape[-1]
    return (6 * (x.numel() // C) * C * w2.shape[1],
            _nbytes(x, w1, b1, w2, b2, out), PEAK_BF16_FLOPS)


def mi_work(args, out):
    """(flops, bytes, peak): 4 FMAs per live sample and channel in fp32;
    the value texels the samples can touch (at most the live images), the
    query-side tables and the output moved once."""
    value, delta, shapes, ref, off_q, wq, inv_base = args
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(shapes)
    live = (delta.reshape(Bv, H, n_img, L * P, 3)[..., 2] != 0).any(-1)
    live_bhn = int(live.sum())
    samples = live_bhn * (B // Bv) * Lq * L * P
    touched = min(live_bhn * S * D, 4 * samples * D) * value.element_size()
    return (8 * samples * D,
            touched + _nbytes(delta, ref, off_q, wq, out), PEAK_FP32_FLOPS)


def bound_ms(flops, nbytes, peak):
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms > bytes_ms
                                   else "bytes")


def _err(got, want):
    return float((got.float() - want.float()).abs().max())


def _tol(want) -> float:
    """One bf16 ulp at the output's scale (fp32: 1e-5 of it)."""
    scale = float(want.float().abs().max())
    if want.dtype == torch.float32:
        return 1e-5 * max(scale, 1.0)
    return float(2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7))


def _time(rec, fn, timed):
    if timed:
        rec["ms"] = time_ms(fn)
        rec["device_ms"] = device_ms(fn)
        rec["queued_ms"] = queued_ms(fn)


def launches(fn, runs: int = 5) -> dict:
    """The kernels one call of ``fn`` launches, and each one's device ms a
    call, by the profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_kernel = device_kernels(prof)
    return dict(launches=sum(n for _, n in by_kernel.values()) / runs,
                by_kernel={k[:48]: ms / runs for k, (ms, _) in
                           by_kernel.items()})


def gn_work(args, out):
    """(flops, bytes, peak) of the whole op: x read once, y written once,
    scale and bias read; about 6 fp32 operations an element (the moments,
    the multiply-add, the silu)."""
    x, scale, bias = args[:3]
    return 6 * x.numel(), _nbytes(x, scale, bias, out), PEAK_FP32_FLOPS


def deform_bwd_work(args, out):
    """(flops, bytes, peak) of kernel 3, as `chip_smoke.py` counts it: the
    corners the samples can touch, dOut, the locations and weights read,
    their gradients written; 8 operations a sample and channel."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return (8 * samples * D, touched + _nbytes(grad_out, loc, w, *out),
            PEAK_FP32_FLOPS)


def deform_fwd_work(args, out):
    """(flops, bytes, peak) of kernel 1, as `chip_smoke.py` counts it: the
    value texels the samples can touch, the locations, weights and output;
    8 operations a sample and channel."""
    value, shapes, loc, w = args[:4]
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return 8 * samples * D, touched + _nbytes(loc, w, out), PEAK_FP32_FLOPS


def deform_value_work(args, out):
    """(flops, bytes, peak) of kernel 2, as `chip_smoke.py` counts it: dOut,
    the locations and weights read, the value gradient written once; 8
    operations a sample and channel."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    return (8 * N * Q * H * L * P * value.shape[3],
            _nbytes(grad_out, loc, w, value), PEAK_FP32_FLOPS)


def unfused_geglu(x, w1, b1, w2, b2):
    """The C = 1280 blocks' path: two `F.linear` calls around a plain
    GEGLU (the yardstick; the port never calls it on a fused site)."""
    Fh = w2.shape[1]
    h = F.linear(x, w1, b1)
    return F.linear(h[..., :Fh] * F.gelu(h[..., Fh:]), w2, b2)


def _variant(pick, *shape):
    """The wrapper's variant for a call (None in a checkout whose wrapper
    has no variants)."""
    return pick(*shape) if pick is not None else None


def run_geglu(sites: Dict[str, tuple], timed: bool) -> list:
    kernel = geglu_ops.geglu_cuda
    rows = []
    for site, args in sites.items():
        x, w1, b1, w2, b2 = args
        want = geglu_ops.geglu_plain(*args)
        rec = dict(kernel="geglu_fwd", site=site, shape=list(x.shape),
                   variant=_variant(getattr(geglu_ops, "geglu_variant", None),
                                    x.shape[-1], w2.shape[1], x.dtype))
        if timed:
            with torch.inference_mode():
                got = kernel(*args)
                torch.cuda.synchronize()
            rec["max_abs_err"], rec["tol"] = _err(got, want), _tol(want)
            rec["ok"] = rec["max_abs_err"] <= rec["tol"]
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                *geglu_work(args, got))
            with torch.inference_mode():
                _time(rec, lambda: kernel(*args), timed)
        rows.append(rec)
        if timed:
            with torch.inference_mode():
                fn = lambda: unfused_geglu(*args)
                rows.append(dict(kernel="geglu_unfused", site=site,
                                 ms=time_ms(fn), device_ms=device_ms(fn),
                                 queued_ms=queued_ms(fn)))
    return rows


def run_mi(sites: Dict[str, tuple], timed: bool) -> list:
    kernel = mi_ops.ms_deform_attn_mi_cuda
    rows = []
    for site, args in sites.items():
        want = mi_ops.ms_deform_attn_mi_plain(*args)
        rec = dict(kernel="ms_deform_attn_mi_fwd", site=site,
                   shape=list(args[0].shape), lq=args[4].shape[1],
                   variant=_variant(getattr(mi_ops, "mi_variant", None),
                                    args[0].shape[-1], args[0].dtype),
                   spread=offset_spread(args))
        if timed:
            with torch.inference_mode():
                got = kernel(*args)
                torch.cuda.synchronize()
            rec["max_abs_err"], rec["tol"] = _err(got, want), _tol(want)
            rec["ok"] = rec["max_abs_err"] <= rec["tol"]
            rec["bound_ms"], rec["bound_by"] = bound_ms(*mi_work(args, got))
            with torch.inference_mode():
                _time(rec, lambda: kernel(*args), timed)
        rows.append(rec)
    return rows


def _gn_entry(args):
    """The public entry a GroupNorm site calls."""
    x, scale, bias, groups, eps, silu = args
    fn = gn_ops.group_norm_silu if silu else gn_ops.group_norm
    return lambda: fn(x, scale, bias, groups, eps)


def _gn_plain(args):
    """The plain version: the JAX package's math in plain PyTorch (written
    out from `group_affine`, which older checkouts have too)."""
    x, scale, bias, groups, eps, silu = args
    w, b = gn_ops.group_affine(x, scale, bias, groups, eps)
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    t = x.float() * w.reshape(shape) + b.reshape(shape)
    return (t * torch.sigmoid(t) if silu else t).to(x.dtype)


def run_gn(sites: Dict[str, tuple], timed: bool) -> list:
    rows = []
    for site, args in sites.items():
        x = args[0]
        rec = dict(kernel="group_norm" + ("_silu" if args[5] else ""),
                   site=site, shape=list(x.shape), dtype=str(x.dtype),
                   plan=list(gn_ops.gn_plan(
                       x.shape[0], x.numel() // (x.shape[0] * x.shape[-1]),
                       x.shape[-1], x.dtype))
                   if hasattr(gn_ops, "gn_plan") else None)
        call = _gn_entry(args)
        with torch.inference_mode():
            got, again = call(), call()
            want = _gn_plain(args)
            torch.cuda.synchronize()
            rec["max_abs_err"], rec["tol"] = _err(got, want), _tol(want)
            rec["bit_identical"] = bool(torch.equal(got, again))
            rec["ok"] = rec["max_abs_err"] <= rec["tol"] \
                and rec["bit_identical"]
            rec["bound_ms"], rec["bound_by"] = bound_ms(*gn_work(args, got))
            _time(rec, call, timed)
            rec.update(launches(call))
            rec["plain_ms"] = time_ms(lambda: _gn_plain(args))
            apply = getattr(gn_ops, "group_norm_apply_cuda", None)
            if apply is not None:
                # the apply pass after 128 MB written (x out of the 50 MB
                # L2), beside its time in the op, where x was just read
                wb = gn_ops.group_norm_moments_cuda(*args[:5])
                flush = torch.empty(2 ** 25, device=x.device)
                cold = launches(lambda: (flush.zero_(),
                                         apply(x, wb, args[5])))
                # None where the profiler dropped the kernel's record
                read = [ms for k, ms in cold["by_kernel"].items()
                        if "gn_apply" in k]
                rec["apply_cold_l2_ms"] = read[0] if read else None
                del wb, flush
        rows.append(rec)
        del got, again, want
        torch.cuda.empty_cache()
    return rows


def run_deform_bwd(sites: Dict[str, tuple], timed: bool) -> list:
    kernel = deform_ops.ms_deform_attn_bwd_loc_weight_cuda
    rows = []
    for site, args in sites.items():
        value, shapes, loc, w, grad_out = args
        pick = getattr(deform_ops, "loc_weight_variant", None)
        rec = dict(kernel="ms_deform_attn_bwd_loc_weight", site=site,
                   value=list(value.shape), loc=list(loc.shape),
                   variant=_variant(pick, value.shape[-1], value.dtype))
        call = lambda: kernel(*args)
        with torch.inference_mode():
            got, again = call(), call()
        ref = deform_ops.ms_deform_attn_plain_backward(
            value.float(), shapes, loc.float(), w.float(),
            grad_out.float())[1:]
        torch.cuda.synchronize()
        errs = [_err(g, r) for g, r in zip(got, ref)]
        tols = [2 * _tol(r.to(loc.dtype)) for r in ref]
        rec.update(errs=errs, tols=tols,
                   bit_identical=all(bool(torch.equal(a, b))
                                     for a, b in zip(got, again)))
        rec["ok"] = all(e <= t for e, t in zip(errs, tols)) \
            and rec["bit_identical"]
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            *deform_bwd_work(args, got))
        with torch.inference_mode():
            _time(rec, call, timed)
            rec.update(launches(call))
        rows.append(rec)
        del got, again, ref
        torch.cuda.empty_cache()
    return rows


def decode_inputs(rng, device, shapes, N, H, D, P, dtype=torch.bfloat16):
    """``(value, shapes, loc, w)`` of kernel 1 at the one-query MMFS
    decode: locations uniform over [0, 1], weights summing to about 1."""
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                            dtype=dtype)
    return (t(rng.randn(N, S, H, D)), shapes,
            t(rng.rand(N, 1, H, L, P, 2)), t(rng.rand(N, 1, H, L, P) / (L * P)))


def _deform_row(kernel_name, site, args, call, want, tol, work):
    """Kernel 1's or 2's row: the call against ``want``, bit-identical over
    two calls, its bound, its three times and launches."""
    value, shapes, loc = args[:3]
    rec = dict(kernel=kernel_name, site=site, value=list(value.shape),
               loc=list(loc.shape))
    with torch.inference_mode():
        got, again = call(), call()
        torch.cuda.synchronize()
    rec["max_abs_err"], rec["tol"] = _err(got, want), tol
    rec["bit_identical"] = bool(torch.equal(got, again))
    rec["ok"] = rec["max_abs_err"] <= rec["tol"] and rec["bit_identical"]
    rec["bound_ms"], rec["bound_by"] = bound_ms(*work(args, got))
    with torch.inference_mode():
        _time(rec, call, True)
        rec.update(launches(call))
    return rec


def run_deform_fwd(sites: Dict[str, tuple], timed: bool) -> list:
    """Kernel 1 through `ms_deform_attn_cuda`, against
    `ms_deform_attn_plain` in the same dtype (one ulp at its scale)."""
    kernel = deform_ops.ms_deform_attn_cuda
    pick = getattr(deform_ops, "forward_variant", None)
    rows = []
    for site, args in sites.items():
        args = args[:4]
        want = deform_ops.ms_deform_attn_plain(*args)
        rec = _deform_row("ms_deform_attn_fwd", site, args,
                          lambda: kernel(*args), want, _tol(want),
                          deform_fwd_work)
        rec["variant"] = _variant(pick, args[0].shape[-1], args[0].dtype)
        rows.append(rec)
        del want
        torch.cuda.empty_cache()
    return rows


def run_deform_value(sites: Dict[str, tuple], timed: bool) -> list:
    """Kernel 2 through `ms_deform_attn_bwd_value_cuda`, against autograd
    through the plain version in fp32 (two ulps at the gradient's scale)."""
    kernel = deform_ops.ms_deform_attn_bwd_value_cuda
    pick = getattr(deform_ops, "value_grad_plan", None)
    rows = []
    for site, args in sites.items():
        value, shapes, loc, w, grad_out = args
        ref = deform_ops.ms_deform_attn_plain_backward(
            value.float(), shapes, loc.float(), w.float(),
            grad_out.float())[0]
        rec = _deform_row("ms_deform_attn_bwd_value", site, args,
                          lambda: kernel(*args), ref,
                          2 * _tol(ref.to(value.dtype)), deform_value_work)
        if pick is not None:
            rec["plan"] = pick(shapes, loc.shape[1], loc.shape[3],
                               loc.shape[4], value.shape[-1],
                               value.dtype)._asdict()
        rows.append(rec)
        del ref
        torch.cuda.empty_cache()
    return rows


def synthetic_sites(device, tiny=False) -> dict:
    """Each kernel's sites, from one ``RandomState(SEED)``."""
    rng = np.random.RandomState(SEED)
    geglu = {k: geglu_inputs(T, C, rng, device)
             for k, (T, C) in (TINY_GEGLU if tiny else GEGLU).items()}
    if tiny:
        mi = {k: mi_inputs(lq, rng, device, shapes=((16, 16), (8, 8)), Bv=2,
                           B=4, H=2, D=8, P=2, live=(1,), inv_base=1 / 16)
              for k, lq in TINY_MI.items()}
    else:
        mi = {k: mi_inputs(lq, rng, device) for k, lq in MI_SITES.items()}
        mi["mi_uniform_64px"] = mi_inputs(4096, rng, device, uniform=True)
    gn = {k: gn_inputs(*shape, rng, device)
          for k, shape in (TINY_GN if tiny else GN).items()}
    if tiny:
        bwd = {k: deform_bwd_inputs(q, rng, device, shapes=((8, 8), (4, 4)),
                                    N=2, H=2, D=8, P=2, dtype=torch.float32)
               for k, q in TINY_DEFORM_BWD.items()}
    else:
        bwd = {k: deform_bwd_inputs(q, rng, device)
               for k, q in DEFORM_BWD.items()}
    if tiny:
        dec = dict(shapes=((4, 4), (2, 2)), N=2, H=2, D=8, P=2,
                   dtype=torch.float32)
    else:
        dec = DECODE
    fwd = dict({k: v[:4] for k, v in bwd.items()},
               mmfs_decode=decode_inputs(rng, device, **dec))
    return {"geglu": geglu, "mi": mi, "gn": gn, "deform_bwd": bwd,
            "deform_fwd": fwd, "deform_value": dict(bwd)}


# the kernels line's names, which name the files of a `--sites` directory
SAVED = {"geglu": "geglu_fwd", "mi": "ms_deform_attn_mi_fwd",
         "gn": "group_norm", "deform_bwd": "ms_deform_attn_bwd_loc_weight",
         "deform_value": "ms_deform_attn_bwd_value",
         "deform_fwd": "ms_deform_attn_bwd_value"}


def load_sites(path: str, device, kernels) -> dict:
    """The captured sites `chip_smoke.py` saved, ``<path>/<kernel name>.pt``
    each (``{site: args}``); a kernel without its file gets its seeded
    sites.  Kernels 1 and 2 take the UNet's sites of the value gradient's
    file (kernel 1 their value, locations and weights), kernel 1 also the
    decode site of its own file."""
    seeded = None
    out = {}
    for k in kernels:
        f = Path(path) / f"{SAVED[k]}.pt"
        if f.exists():
            out[k] = torch.load(f, map_location=device, weights_only=False)
            if k in ("deform_fwd", "deform_value"):
                out[k] = {s: a for s, a in out[k].items() if s in DEFORM_BWD}
        else:
            seeded = seeded or synthetic_sites(device)
            out[k] = seeded[k]
        if k == "deform_fwd":
            own = Path(path) / "ms_deform_attn_fwd.pt"
            if own.exists():
                out[k]["mmfs_decode"] = torch.load(
                    own, map_location=device,
                    weights_only=False)["mmfs_decode"]
            else:
                seeded = seeded or synthetic_sites(device)
                out[k]["mmfs_decode"] = seeded[k]["mmfs_decode"]
    return out


KERNELS = ("geglu", "mi", "gn", "deform_bwd", "deform_fwd", "deform_value")


def run(device="cuda", sites: Optional[str] = None,
        kernels=("geglu", "mi")) -> list:
    """Every row of ``kernels``; on the card each call is checked and
    timed."""
    timed = device == "cuda"
    if timed and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    cases = (load_sites(sites, device, kernels) if sites
             else synthetic_sites(device, tiny=not timed))
    if not timed:
        plain = dict(
            geglu=("geglu_fwd", lambda a: geglu_ops.geglu_plain(*a)),
            mi=("ms_deform_attn_mi_fwd",
                lambda a: mi_ops.ms_deform_attn_mi_plain(*a)),
            gn=("group_norm", _gn_plain),
            deform_bwd=("ms_deform_attn_bwd_loc_weight",
                        lambda a: deform_ops.ms_deform_attn_plain_backward(
                            *a)[1]),
            deform_fwd=("ms_deform_attn_fwd",
                        lambda a: deform_ops.ms_deform_attn_plain(*a[:4])),
            deform_value=("ms_deform_attn_bwd_value",
                          lambda a: deform_ops.ms_deform_attn_plain_backward(
                              *a)[0]))
        return [dict(kernel=plain[k][0], site=s, finite=bool(
            torch.isfinite(plain[k][1](a).float()).all()))
            for k in kernels for s, a in cases[k].items()]
    runners = dict(geglu=run_geglu, mi=run_mi, gn=run_gn,
                   deform_bwd=run_deform_bwd, deform_fwd=run_deform_fwd,
                   deform_value=run_deform_value)
    return [row for k in kernels for row in runners[k](cases[k], timed)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--sites", default=None,
                    help="directory of the inputs chip_smoke.py captured")
    ap.add_argument("--kernels", nargs="+", default=["geglu", "mi"],
                    choices=KERNELS)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("bench_unet_kernels: no CUDA device")
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    rows = run(a.device, a.sites, a.kernels)
    for row in rows:
        print(json.dumps(row), flush=True)
    bad = [r for r in rows if r.get("ok") is False or r.get("finite") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
