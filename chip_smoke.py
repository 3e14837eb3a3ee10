#!/usr/bin/env python3
"""Drive the PyTorch port (`mm_interleaved_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits nonzero) on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and convolutions;
2. build every CUDA kernel under ``mm_interleaved_tpu_torch/csrc/``;
3. small reference: the tiny preset in fp32 on the card against the same
   weights on the CPU (the kernel against the plain path, end to end);
4. the slice: the flagship preset (Vicuna-13B width and depth, CLIP
   ViT-L/14 + adapter, 12-layer Q-Former; no image decoder) in bf16 with
   seeded random weights made on the card.  `generate_texts` for B=2,
   256-token prompts with 2 images each, 32 greedy tokens, eos off:
   shapes, finite logits, tokens in vocabulary, two runs identical, and
   the kernel's launch count equal to the path's call count;
5. the kernel against its plain version on the inputs captured at the
   first Injector, Extractor, MMFS prefill and MMFS decode calls, in bf16
   and fp32, each timed with CUDA events (median of 25).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``.  Needs one CUDA card and the
repository checkout around it; imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
B = 2
PROMPT_LEN = 256
N_IMG = 2
NEW_TOKENS = 32
TIMING_RUNS = 25
REPLACES = ("mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:237 "
            "_kernel_v5")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def perturb_zero_inits(model, seed: int) -> None:
    """Small seeded values for the parameters the JAX init leaves at zero
    (gates, gammas, deformable offset/weight kernels, ignore tokens), so
    that the deformable branches reach the logits."""
    import torch

    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 2)[-2] if name.count(".") else ""
        if leaf in ("gate", "gamma"):
            p.data.normal_(0.0, 0.3, generator=g)
        elif leaf in ("ignore_token", "adapter_level_embed"):
            p.data.normal_(0.0, 0.1, generator=g)
        elif parent in ("sampling_offsets", "attention_weights") \
                and leaf == "weight":
            p.data.normal_(0.0, 0.5 * p.shape[1] ** -0.5, generator=g)


def make_prompt(special, rng: np.random.RandomState, n_img_tok: int):
    """B rows of PROMPT_LEN tokens: <bos>, text, then N_IMG blocks of
    <soi> + n_img_tok <image>, each followed by text; row 1 is left-padded
    by 8 tokens."""
    def text(n):
        return list(rng.randint(3, special.pad_token_id, size=n))

    body_text = PROMPT_LEN - 1 - N_IMG * (1 + n_img_tok)
    chunk = (body_text - 8 * (B - 1)) // (N_IMG + 1)
    rows, masks = [], []
    for b in range(B):
        pad = 8 * b
        n_text = body_text - pad
        parts = [special.bos_token_id] + text(chunk)
        for _ in range(N_IMG):
            parts += [special.soi_token_id] + [special.image_token_id] * n_img_tok
            parts += text(chunk)
        parts += text(n_text - (N_IMG + 1) * chunk)
        row = [special.pad_token_id] * pad + parts
        assert len(row) == PROMPT_LEN, len(row)
        rows.append(row)
        masks.append([0] * pad + [1] * (PROMPT_LEN - pad))
    return np.array(rows, np.int64), np.array(masks, np.int32)


class Capture:
    """Wraps the kernel wrapper to keep the first inputs of each call site
    (Injector: 3 levels x 4 points; Extractor: 1 level; MMFS prefill /
    decode: 3 levels x 8 points, Lq > 1 / Lq == 1)."""

    def __init__(self, mod):
        self.mod = mod
        self.orig = mod.ms_deform_attn_cuda
        self.cases = {}

    def site(self, loc):
        L, P, Q = loc.shape[3], loc.shape[4], loc.shape[1]
        if P == 4:
            return "injector" if L > 1 else "extractor"
        return "mmfs_prefill" if Q > 1 else "mmfs_decode"

    def __enter__(self):
        orig, cases = self.orig, self.cases

        def wrapped(value, shapes, loc, w):
            key = self.site(loc)
            if key not in cases:
                cases[key] = (value.clone(), tuple(shapes), loc.clone(),
                              w.clone())
            return orig(value, shapes, loc, w)

        self.mod.ms_deform_attn_cuda = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.ms_deform_attn_cuda = self.orig


def time_ms(fn, runs: int = TIMING_RUNS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def teacher_forced_logits(model, text_ids, images, n_img, att, tokens):
    """Prefill logits of the last prompt position, then the logits of each
    decode step fed ``tokens`` (as `generate_tokens` feeds its own)."""
    import torch

    from mm_interleaved_tpu_torch.models.llama import KVCache

    with torch.inference_mode():
        prep = model.prepare_mm_embeds(text_ids, images, n_img)
        cache = KVCache.create(model.cfg.llm, text_ids.shape[0],
                               text_ids.shape[1] + tokens.shape[1],
                               device=text_ids.device,
                               dtype=model.soi_token.dtype)
        logits, _, cache, values = model.lm_prefill(
            prep["mm_embeds"], att, prep["mmfs_values"],
            prep["cross_attention_mask"], cache,
        )
        out = [logits[:, -1].float()]
        cross = prep["cross_attention_mask"][:, -1:]
        ones = torch.ones_like(att[:, :1])
        for t in range(tokens.shape[1] - 1):
            step, cache = model.lm_decode_step(
                tokens[:, t:t + 1], ones, None, cross, cache, values
            )
            out.append(step[:, 0].float())
    return torch.stack(out, dim=1)


def small_reference() -> dict:
    """Tiny preset, fp32: the card (kernel) against the CPU (plain)."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = tiny_config(with_image_decoder=False)
    s = cfg.special
    cpu = build_model(cfg, "cpu", torch.float32, seed=SEED)
    perturb_zero_inits(cpu, SEED + 1)
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(SEED)
    row = [s.bos_token_id, 5, s.soi_token_id] + [s.image_token_id] * \
        cfg.num_img_token + [7, 8, s.soi_token_id] + \
        [s.image_token_id] * cfg.num_img_token + [9]
    ids = torch.tensor([row, [s.pad_token_id] + row[:-1]])
    att = (ids != s.pad_token_id).int()
    imgs = torch.from_numpy(
        rng.rand(2, cfg.max_num_images, 56, 56, 3).astype(np.float32))
    n_img = torch.tensor([2, 2])
    gen = TextGenerationConfig(max_new_tokens=8, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    tok_cpu = generate_texts(cpu, ids, imgs, n_img, att, gen)
    want = teacher_forced_logits(cpu, ids, imgs, n_img, att, tok_cpu)
    dev = [t.cuda() for t in (ids, imgs, n_img, att, tok_cpu)]
    got = teacher_forced_logits(gpu, *dev).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"tiny fp32 logits card vs CPU: {err} "
                             f"(scale {scale})")
    tok_gpu = generate_texts(gpu, *dev[:4], gen).cpu()
    top2 = want.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    if margin > 10 * err and not torch.equal(tok_gpu, tok_cpu):
        raise AssertionError(f"tiny greedy tokens differ: {tok_gpu} vs "
                             f"{tok_cpu}")
    return dict(logits_max_abs_err=err, logits_scale=scale,
                top2_margin=margin, tokens_equal=torch.equal(tok_gpu, tok_cpu))


def run_slice(model, kmod, device: str) -> dict:
    """`generate_texts` through the model: a capturing warm-up, a 1-token
    run (prefill time), the counted 32-token run and a second one; then a
    prefill whose logits are checked.  Raises on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.llama import KVCache

    cfg = model.cfg
    s = cfg.special
    rng = np.random.RandomState(SEED)
    ids, att = make_prompt(s, rng, cfg.num_img_token)
    ids = torch.from_numpy(ids).to(device)
    att = torch.from_numpy(att).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    size = cfg.visual.encoder.vit.image_size
    images = torch.rand((B, N_IMG, size, size, 3), generator=g,
                        device=device)
    n_img = torch.full((B,), N_IMG, dtype=torch.int64, device=device)
    gen = TextGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)

    def run(new_tokens):
        c = dataclasses.replace(gen, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate_texts(model, ids, images, n_img, att, c)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with Capture(kmod) as cap:  # warm-up, and the kernel's real inputs
        run(2)
    if sorted(cap.cases) != ["extractor", "injector", "mmfs_decode",
                             "mmfs_prefill"]:
        raise AssertionError(f"captured call sites {sorted(cap.cases)}")
    _, prefill_ms = run(1)

    torch.cuda.reset_peak_memory_stats()
    kmod.ms_deform_attn_cuda.launches = 0
    tokens, gen_ms = run(NEW_TOKENS)
    launches = kmod.ms_deform_attn_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens2, _ = run(NEW_TOKENS)

    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    expected = (2 * adapter.num_interactions + adapter.extra_extractors
                + n_cross * NEW_TOKENS)
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    if tuple(tokens.shape) != (B, NEW_TOKENS):
        raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
    if not ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all():
        raise AssertionError("tokens out of vocabulary")
    if not torch.equal(tokens, tokens2):
        raise AssertionError("two greedy runs differ")
    with torch.inference_mode():
        prep = model.prepare_mm_embeds(ids, images, n_img)
        cache = KVCache.create(cfg.llm, B, PROMPT_LEN, device=device,
                               dtype=model.soi_token.dtype)
        logits = model.lm_prefill(prep["mm_embeds"], att, prep["mmfs_values"],
                                  prep["cross_attention_mask"], cache)[0]
    if tuple(logits.shape) != (B, PROMPT_LEN, cfg.llm.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    return dict(tokens=tokens, launches=launches, prefill_ms=prefill_ms,
                gen_ms=gen_ms,
                decode_ms=(gen_ms - prefill_ms) / (NEW_TOKENS - 1),
                peak_gb=peak_gb, cases=cap.cases)


def compare_sites(kmod, cases, timer) -> list:
    """The kernel against its plain version on each captured call, in bf16
    and fp32, with both timed by ``timer``."""
    import torch

    sites = []
    for name in ("injector", "extractor", "mmfs_prefill", "mmfs_decode"):
        value, shapes, loc, w = cases[name]
        site = dict(site=name, value_shape=list(value.shape),
                    levels=[list(x) for x in shapes], points=loc.shape[4],
                    queries=loc.shape[1])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            v, l_, w_ = value.to(dt), loc.to(dt), w.to(dt)
            got = kmod.ms_deform_attn_cuda(v, shapes, l_, w_)
            want = kmod.ms_deform_attn_plain(v, shapes, l_, w_)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            if tag == "fp32":  # only the summation order differs
                tol = 1e-5
            else:  # one bf16 ulp at the output's scale
                tol = float(2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7))
            if not err <= tol:
                raise AssertionError(f"{name} {tag}: kernel vs plain "
                                     f"{err} > {tol}")
            site[f"max_abs_err_{tag}"] = err
            site[f"tol_{tag}"] = tol
            site[f"scale_{tag}"] = scale
            site[f"ms_{tag}"] = timer(
                lambda: kmod.ms_deform_attn_cuda(v, shapes, l_, w_))
            site[f"plain_ms_{tag}"] = timer(
                lambda: kmod.ms_deform_attn_plain(v, shapes, l_, w_))
        sites.append(site)
        log(f"kernel vs plain, {name}: {json.dumps(site)}")
    return sites


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mm_interleaved_tpu_torch.ops import cuda_build
        from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as kmod
    except ImportError as e:
        print(f"chip_smoke: run from the repository checkout ({e})",
              file=sys.stderr)
        return 2
    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    # 1. environment
    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    names = cuda_build.build_all()
    log(f"built {names} in {time.perf_counter() - t0:.1f} s")

    # 3. small reference
    ref = small_reference()
    log(f"small reference (tiny, fp32, card vs CPU): {json.dumps(ref)}")

    # 4. the slice at flagship width and depth
    cfg = dataclasses.replace(flagship_config(max_num_images=N_IMG),
                              image_decoder=None)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship (no image decoder): {n_params / 1e9:.3f} B params, bf16, "
        f"built on the card in {time.perf_counter() - t0:.1f} s")
    res = run_slice(model, kmod, "cuda")
    log(f"slice: B={B} prompt={PROMPT_LEN} images/row={N_IMG} "
        f"new_tokens={NEW_TOKENS}: prefill (encode + LLM prefill + first "
        f"token) {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms']:.2f} ms/token, generate_texts "
        f"{res['gen_ms']:.1f} ms, peak memory {res['peak_gb']:.2f} GB, "
        f"kernel launches {res['launches']}")
    log(f"tokens[0][:16] = {res['tokens'][0, :16].tolist()}")
    del model

    # 5. the kernel against its plain version at the captured shapes
    sites = compare_sites(kmod, res["cases"], time_ms)
    launches = res["launches"]

    kernel_ms = sum(x["ms_bf16"] for x in sites)
    plain_ms = sum(x["plain_ms_bf16"] for x in sites)
    log(json.dumps({"kernels": [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "mm_interleaved_tpu_torch/csrc/ms_deform_attn.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(x["max_abs_err_bf16"] for x in sites),
        "max_abs_err_fp32": max(x["max_abs_err_fp32"] for x in sites),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "kernel_ms": kernel_ms,
        "timing": "sum over the four captured call sites, bf16, median of "
                  f"{TIMING_RUNS} CUDA-event runs each",
        "sites": sites,
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
