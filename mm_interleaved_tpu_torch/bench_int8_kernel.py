"""The int8 weight-only linear kernel (`ops/quant.py`, ``csrc/int8_linear.cu``)
at the flagship's projection sites, in a process of its own.

    python -m mm_interleaved_tpu_torch.bench_int8_kernel          # card
    python -m mm_interleaved_tpu_torch.bench_int8_kernel --e2e    # and the text slice
    python -m mm_interleaved_tpu_torch.bench_int8_kernel --device cpu

The sites are the shapes the flagship's LLM gives the kernel (Vicuna-13B:
hidden 5120, MLP 13824, vocabulary 32002 and the two new special tokens):
``qkvo`` [M, 5120] x [5120, 5120], ``gate_up`` x [13824, 5120], ``down``
[M, 13824] x [5120, 13824], ``head`` x [32002, 5120] and ``head_new`` x
[2, 5120] (the heads with a bias), at M = 2 (greedy decode, B = 2), 6 and
10 (K = 3 and 5 beams), 8 (the bench's decode) and 512 (the prefill and
the image prefix forward: 2 rows of 256 tokens).  Inputs are seeded
(``torch.Generator``, seed 0); each site holds enough copies of its
weights to exceed the 50 MB L2 cache, and every timed call takes the next
copy, as each layer of the model reads weights of its own.

Each site, as `int8_linear_cuda` serves it (the body and plan its wrapper
picks, logged where the checkout has them), is held against the plain
version (the bound `chip_smoke.int8_tolerance` derives) and timed three
ways: ``ms``, the median of 25 synchronised CUDA-event runs; ``device_ms``,
the mean device time of 12 calls under `torch.profiler`; ``queued_ms``,
the mean of 25 calls enqueued back to back.  ``library_*``: `F.linear` on
the dequantized bf16 weight (cuBLAS), the yardstick.  ``bound_ms``: the
larger of the bytes (x, the codes, the scales, the bias and the output
once each) over 3.35 TB/s and 2 M N K over 989 TFLOP/s.  ``host_us``: the
host's time a call of the wrapper (`int8_linear_cuda`, checks, the plan,
the output's allocation and the ctypes entry with its tensor maps) and of
`int8_linear` (what `QLinear` calls) at M = 2: the median of 9 batches of
100 calls enqueued without a synchronise, the device faster than the
host.

``--e2e`` then builds the flagship (seeded bf16, its image decoder),
quantizes its LLM in place and times phase 16b's text slice of
`chip_smoke.py`: the first token (a 1-token `generate_texts`), decode
ms/token over 32 greedy tokens, and the caption route's beam (K = 5, 20
tokens) ms/token, on `chip_smoke.prompt_inputs`' prompt; after a warm-up,
the median of 3 rounds (each round's values are logged too: the host's
time dominates these, and it varies from run to run).

The module needs only the public entries it times, so copied into an
older checkout of the package it measures that checkout's kernel on the
same inputs: before and after in one call.  ``--device cpu`` runs the
plain version at a tiny size and times nothing.  The card's ``nvidia-smi``
name and power line, then one JSON row per site (and one for ``--e2e``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .ops import quant
from .ops.quant import (dequantize_int8, int8_linear, int8_linear_cuda,
                        int8_linear_plain, quantize_int8)
from .utils.timing import (PEAK_BF16_FLOPS, PEAK_BYTES, card_line,
                           device_ms, queued_ms, time_ms)

SEED = 0
# name: (N, K, bias)
SHAPES = {
    "qkvo": (5120, 5120, False),
    "gate_up": (13824, 5120, False),
    "down": (5120, 13824, False),
    "head": (32002, 5120, True),
    "head_new": (2, 5120, True),
}
ROWS = (2, 6, 8, 10, 512)
L2_BYTES = 50e6
HOST_CALLS = 100
HOST_BATCHES = 9
E2E_REPS = 3


def work(M: int, N: int, K: int, bias: bool):
    """(flops, bytes) of one call in bf16."""
    nbytes = M * K * 2 + N * K + 4 * N + M * N * 2 + (2 * N if bias else 0)
    return 2 * M * N * K, nbytes


def tolerance(x, q, scale, bias, got, want):
    """`chip_smoke.int8_tolerance`: the order of two fp32 sums of the same
    products and the roundings to the output dtype after them."""
    w = dequantize_int8(q, scale, x.dtype).float().abs()
    sums = x.float().abs() @ w.t()
    mag = got.float().abs() + want.float().abs()
    if bias is not None:
        mag = mag + bias.float().abs()
    return x.shape[1] * 2.0 ** -23 * sums + 2 * 2.0 ** -7 * mag


def _served(M: int, N: int, K: int):
    """The body and plan this checkout's wrapper picks (None where the
    checkout has no such function)."""
    body = getattr(quant, "int8_linear_body")
    try:
        name = body(M, N, K, torch.bfloat16)
    except TypeError:  # a checkout whose body took (M, dtype)
        name = body(M, torch.bfloat16)
    plan = getattr(quant, "int8_linear_plan", None)
    if name != "wgmma" or plan is None:
        return name, None
    p = plan(M, N, K, torch.cuda.get_device_properties(0)
             .multi_processor_count)
    return name, dict(bn=p["bn"], split=p["split"])


def _cycle(fn, n: int):
    it = itertools.cycle(range(n))
    return lambda: fn(next(it))


def run_site(name: str, M: int, device: str, g) -> dict:
    N, K, has_bias = SHAPES[name]
    dt = torch.bfloat16 if device == "cuda" else torch.float32
    if device != "cuda":  # the plain version at a tiny size
        N, K = min(N, 48), 64
    copies = max(2, int(L2_BYTES // (N * K)) + 1) if device == "cuda" else 1
    ws = []
    for _ in range(copies):
        q, s = quantize_int8(torch.randn(N, K, generator=g, device=device))
        b = torch.randn(N, generator=g, device=device).to(dt) \
            if has_bias else None
        ws.append((q, s, b))
    x = torch.randn(M, K, generator=g, device=device).to(dt)
    flops, nbytes = work(M, N, K, has_bias)
    rec = dict(site=f"{name}_M{M}", M=M, N=N, K=K, bias=has_bias,
               copies=copies, flops=flops, bytes=nbytes,
               bound_ms=max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
               * 1e3)
    if device != "cuda":
        y = int8_linear(x, *ws[0])
        rec["finite"] = bool(torch.isfinite(y).all())
        return rec
    rec["body"], rec["plan"] = _served(M, N, K)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        got = int8_linear_cuda(x, *ws[0])
        again = int8_linear_cuda(x, *ws[0])
        want = int8_linear_plain(x, *ws[0])
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    rec["worst_err_over_tol"] = float(
        (err / tolerance(x, *ws[0], got, want)).max())
    rec["bit_identical"] = torch.equal(got, again)
    kernel = _cycle(lambda i: int8_linear_cuda(x, *ws[i]), copies)
    lib_w = [(dequantize_int8(q, s, dt), b) for q, s, b in ws[:2]]
    library = _cycle(lambda i: F.linear(x, *lib_w[i]), 2)
    for key, fn in (("", kernel), ("library_", library)):
        rec[f"{key}ms"] = time_ms(fn)
        rec[f"{key}device_ms"] = device_ms(fn, runs=12)
        rec[f"{key}queued_ms"] = queued_ms(fn)
    del lib_w
    if M == 2:
        for key, fn in (("host_us", int8_linear_cuda), ("host_us_qlinear",
                                                        int8_linear)):
            rec[key] = host_us(fn, x, ws)
    return rec


def host_us(fn, x, ws) -> float:
    """The host's microseconds a call of ``fn``: the median over
    ``HOST_BATCHES`` batches of ``HOST_CALLS`` calls enqueued without a
    synchronise (each batch starts on an idle card)."""
    fn(x, *ws[0])
    times = []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(HOST_CALLS):
            fn(x, *ws[i % len(ws)])
        times.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def run_e2e() -> dict:
    """The flagship quantized: first token, decode ms/token (32 greedy
    tokens) and the K = 5 caption beam's ms/token (20 tokens, its 1-token
    run subtracted), on phase 16b's prompt: the median of `E2E_REPS`
    rounds after a warm-up."""
    import dataclasses
    import gc

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke as smoke

    from .configs import flagship_config
    from .generation.text import TextGenerationConfig, generate_texts
    from .models.mm_interleaved import build_model
    from .ops.quant import quantize_llm_weights

    def timed(cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_texts(model, ids, images, n_img, att, cfg)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model = build_model(flagship_config(max_num_images=smoke.N_IMG), "cuda",
                        torch.bfloat16, seed=smoke.SEED)
    smoke.perturb_zero_inits(model, smoke.SEED + 1)
    quantize_llm_weights(model)
    gc.collect()
    torch.cuda.empty_cache()
    ids, images, n_img, att = smoke.prompt_inputs(model.cfg, "cuda")
    s = model.cfg.special
    gen = TextGenerationConfig(max_new_tokens=smoke.NEW_TOKENS,
                               eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    one = dataclasses.replace(gen, max_new_tokens=1)
    beam = TextGenerationConfig(
        eos_token_ids=(s.eos_token_id, s.soi_token_id),
        pad_token_id=s.pad_token_id, **smoke.CAPTION_BEAM)
    timed(dataclasses.replace(gen, max_new_tokens=2))
    timed(beam)
    T = smoke.CAPTION_BEAM["max_new_tokens"]
    firsts, decodes, beams = [], [], []
    for _ in range(E2E_REPS):
        _, first_ms = timed(one)
        tokens, gen_ms = timed(gen)
        btok, beam_ms = timed(beam)
        firsts.append(first_ms)
        decodes.append((gen_ms - first_ms) / (smoke.NEW_TOKENS - 1))
        beams.append((beam_ms - first_ms) / (T - 1))
    rec = dict(site="e2e_flagship_int8", reps=E2E_REPS,
               first_ms=float(np.median(firsts)),
               decode_ms_per_token=float(np.median(decodes)),
               beam5_ms_per_token=float(np.median(beams)),
               first_ms_all=firsts, decode_ms_all=decodes, beam5_ms_all=beams,
               tokens=tokens[:, :8].tolist(),
               beam_tokens=btok[:, :8].tolist())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run(device: str = "cuda", e2e: bool = False) -> list:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_int8_kernel: no CUDA device (pass "
                           "--device cpu for the plain version)")
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    rows = []
    for M in (ROWS if device == "cuda" else (2,)):
        for name in SHAPES:
            rec = run_site(name, M, device, g)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
            if device == "cuda":
                torch.cuda.empty_cache()
    if e2e and device == "cuda":
        rec = run_e2e()
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(card_line(), flush=True)
    run(args.device, args.e2e)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
