#!/usr/bin/env python3
"""Drive the PyTorch port (`mm_interleaved_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits nonzero) on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and convolutions;
2. build every CUDA kernel under ``mm_interleaved_tpu_torch/csrc/`` (one
   nvcc each, in parallel) and print how long it took;
3. small reference: the tiny preset with its image decoder in fp32 on the
   card (kernels) against the same weights on the CPU (plain versions):
   text logits along greedy tokens, then `generate_image_inputs` and 3
   DDPM steps of `generate_images` with the same injected latents and
   noise, images within 1e-4;
4. the flagship preset with its image decoder (Vicuna-13B width and depth,
   CLIP ViT-L/14 + adapter, 12-layer Q-Former, the SD-2.1-base UNet with
   MMFS over four pyramid levels, the SD VAE, 512 px) in bf16 with seeded
   random weights made on the card;
5. the text slice: `generate_texts` for B=2, 256-token prompts with 2
   images each, 32 greedy tokens, eos off: shapes, finite logits, tokens
   in vocabulary, two runs identical, kernel 1's launch count equal to the
   path's call count;
6. the image slice on the same prompt: `generate_image_inputs`, then
   `generate_images` on all 4 target rows, 25 DDPM steps, guidance 3.5:
   images [4, 512, 512, 3], finite, in [0, 1], two seeded runs identical,
   the live rows moved by the MMFS values, and every kernel's launch count
   equal to the count derived from the config;
7. each kernel against its plain version on the inputs captured at each
   distinct call shape of the path, and at the first call of the tiny
   preset's image path (whose widths take the kernels' CUDA-core variants
   in bf16), in bf16 and fp32, each timed with CUDA events (median of 25),
   beside its bound and, for flash attention,
   `scaled_dot_product_attention`.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and last ``{"ok": true, "device": {...}}``.  Needs one CUDA card and the
repository checkout around it; imports no JAX.
"""

from __future__ import annotations

import contextlib
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
IMG_STEPS = 25
GUIDANCE = 3.5
TIMING_RUNS = 25
PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
KERNELS = {
    "ms_deform_attn_fwd": dict(
        module="ms_deform_attn_cuda", kernel="ms_deform_attn_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:237 "
                 "_kernel_v5"),
    "ms_deform_attn_mi_fwd": dict(
        module="ms_deform_attn_mi", kernel="ms_deform_attn_mi_cuda",
        plain="ms_deform_attn_mi_plain", source="ms_deform_attn_mi.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_mi.py:68 "
                 "_kernel_mi"),
    "flash_attention_fwd": dict(
        module="flash_attention", kernel="flash_attention",
        plain="attention_plain", source="flash_attention.cu",
        replaces="mm_interleaved_tpu/ops/flash_attention.py:19 "
                 "flash_attention"),
    "group_norm_silu_apply": dict(
        module="group_norm", kernel="group_norm_silu_apply_cuda",
        plain="group_norm_silu_apply_plain", source="group_norm_silu.cu",
        replaces="mm_interleaved_tpu/ops/group_norm.py:74 "
                 "_apply_silu_kernel"),
    "geglu_fwd": dict(
        module="geglu", kernel="geglu_cuda", plain="geglu_plain",
        source="geglu.cu",
        replaces="mm_interleaved_tpu/ops/geglu.py:67 _kernel"),
}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kmod(name):
    import importlib

    return importlib.import_module(
        f"mm_interleaved_tpu_torch.ops.{KERNELS[name]['module']}")


def kernel_of(name):
    return getattr(kmod(name), KERNELS[name]["kernel"])


def reset_counts():
    for name in KERNELS:
        kernel_of(name).launches = 0


def read_counts():
    return {name: kernel_of(name).launches for name in KERNELS}


def perturb_zero_inits(model, seed: int) -> None:
    """Small seeded values for the parameters the JAX init leaves at zero
    (gates, gammas, deformable offset/weight kernels, ignore tokens, the
    UNet MMFS blocks' output convs), so that the deformable branches reach
    the logits and the pixels."""
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
        elif parent == "conv" and ".mmfs_net." in name:
            std = 0.5 * p.shape[1] ** -0.5 if leaf == "weight" else 0.1
            p.data.normal_(0.0, std, generator=g)


def make_prompt(special, rng: np.random.RandomState, n_img_tok: int):
    """B rows of PROMPT_LEN tokens: <bos>, text, then N_IMG blocks of
    <soi> + n_img_tok <image>, each followed by text; row 1 is left-padded
    by 8 tokens.  One document per row, so each row's image 2 has image 1
    as its previous image."""
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


# --------------------------------------------------------------------------
# capturing each kernel's inputs at each distinct call site


def _site_deform(value, shapes, loc, w):
    L, P, Q = loc.shape[3], loc.shape[4], loc.shape[1]
    if P == 4:
        return "injector" if L > 1 else "extractor"
    return "mmfs_prefill" if Q > 1 else "mmfs_decode"


def _site_mi(value, delta, shapes, ref, off_q, wq, inv_base):
    return f"unet_{int(round(off_q.shape[1] ** 0.5))}px"


def _site_flash(q, k, v, causal=False, **kw):
    """The module making the call, told apart by shape; a shape of no known
    call gets a name of its own, which fails the capture check."""
    _, Tq, H, D = q.shape
    Tk = k.shape[1]
    px = int(round(Tq ** 0.5))
    if causal:
        return "llm_prefix"
    if Tq == Tk == 257:
        return "vit"
    if H == 12:
        return "qformer_self" if Tq == Tk else "qformer_cross"
    if Tq == Tk == 77:
        return "decoder_perceiver"
    if px * px == Tq and Tk in (Tq, 77):
        return f"unet_attn{1 if Tk == Tq else 2}_{px}px"
    return f"Tq{Tq}_Tk{Tk}_H{H}_D{D}"


def _site_gn(x, w, b):
    if x.shape[1] == 64 and x.shape[-1] == 320:
        return "unet_64px"
    if x.shape[1] == 512:
        return "vae_512px"
    return None


def _site_geglu(x, w1, b1, w2, b2):
    return f"C{x.shape[-1]}"


SITES = {
    "ms_deform_attn_fwd": _site_deform,
    "ms_deform_attn_mi_fwd": _site_mi,
    "flash_attention_fwd": _site_flash,
    "group_norm_silu_apply": _site_gn,
    "geglu_fwd": _site_geglu,
}
# "tiny" is the first call of the tiny preset's image path: its widths (head
# dim 8, GEGLU width 16) take the kernels' CUDA-core variants in bf16
TINY = "tiny"
WANT_SITES = {
    "ms_deform_attn_fwd": ["extractor", "injector", "mmfs_decode",
                           "mmfs_prefill", TINY],
    "ms_deform_attn_mi_fwd": ["unet_64px", "unet_32px", "unet_16px",
                              "unet_8px", TINY],
    "flash_attention_fwd": ["llm_prefix", "vit", "qformer_self",
                            "qformer_cross", "decoder_perceiver",
                            "unet_attn1_64px", "unet_attn1_32px",
                            "unet_attn1_16px", "unet_attn1_8px",
                            "unet_attn2_64px", "unet_attn2_32px",
                            "unet_attn2_16px", "unet_attn2_8px", TINY],
    "group_norm_silu_apply": ["unet_64px", "vae_512px", TINY],
    "geglu_fwd": ["C320", "C640", TINY],
}


def check_sites(name, cases):
    got = sorted(cases.get(name, {}))
    if got != sorted(WANT_SITES[name]):
        raise AssertionError(f"{name}: captured sites {got} != "
                             f"{sorted(WANT_SITES[name])}")


@contextlib.contextmanager
def capture(names, cases, site=None):
    """Wrap each kernel's wrapper to keep (clones of) the first inputs of
    each call site in ``cases[name][site]``; a fixed ``site`` names the
    first call alone."""
    import torch

    saved = []
    for name in names:
        mod, attr = kmod(name), KERNELS[name]["kernel"]
        orig = getattr(mod, attr)
        site_of = SITES[name] if site is None else (lambda *a, **k: site)
        store = cases.setdefault(name, {})

        def wrapped(*args, _orig=orig, _site=site_of, _store=store, **kw):
            key = _site(*args, **kw)
            if key is not None and key not in _store:
                _store[key] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), {
                    k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()}
            return _orig(*args, **kw)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, orig))
    try:
        yield cases
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


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


# --------------------------------------------------------------------------
# the small reference


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


def small_reference(cases) -> dict:
    """Tiny preset with its image decoder, fp32: the card (kernels) against
    the CPU (plain versions).  Keeps the first inputs of each kernel on the
    card's image path as its ``TINY`` site."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.generation.diffusion import generate_images
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, image_decoder=dataclasses.replace(
        cfg.image_decoder, vae_decode_dtype="float32"))
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
    reset_counts()
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

    # the image path: the same prompt, injected draws
    steps = 3
    inp_cpu = cpu.generate_image_inputs(ids, imgs, n_img, att)
    with capture(list(KERNELS), cases, site=TINY):
        inp_gpu = gpu.generate_image_inputs(*dev[:4])
    inputs_err = max(float((a.cpu().float() - b.float()).abs().max())
                     for a, b in zip(inp_gpu, inp_cpu))
    if not inputs_err <= 1e-4:
        raise AssertionError(f"tiny generate_image_inputs card vs CPU: "
                             f"{inputs_err}")
    if int(inp_cpu[3].sum()) == 0:
        raise AssertionError("tiny prompt has no previous image")
    idc = cfg.image_decoder
    shape = (inp_cpu[0].shape[0], idc.latent_size, idc.latent_size,
             idc.vae.latent_channels)
    latents = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    noises = torch.from_numpy(rng.randn(steps, *shape).astype(np.float32))
    kw = dict(num_inference_steps=steps, guidance_scale=2.0)
    img_cpu = generate_images(cpu, *inp_cpu, latents=latents, noises=noises,
                              **kw)
    with capture(list(KERNELS), cases, site=TINY):
        img_gpu = generate_images(gpu, *inp_gpu, latents=latents.cuda(),
                                  noises=noises.cuda(), **kw).cpu()
    img_err = float((img_gpu - img_cpu).abs().max())
    if not img_err <= 1e-4:
        raise AssertionError(f"tiny images card vs CPU: {img_err}")
    counts = read_counts()
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"tiny card run missed a kernel: {counts}")
    return dict(logits_max_abs_err=err, logits_scale=scale,
                top2_margin=margin, tokens_equal=torch.equal(tok_gpu, tok_cpu),
                image_inputs_max_abs_err=inputs_err,
                images_max_abs_err=img_err, launches=counts)


# --------------------------------------------------------------------------
# the flagship slices


def prompt_inputs(cfg, device):
    import torch

    s = cfg.special
    rng = np.random.RandomState(SEED)
    ids, att = make_prompt(s, rng, cfg.num_img_token)
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    size = cfg.visual.encoder.vit.image_size
    images = torch.rand((B, N_IMG, size, size, 3), generator=g,
                        device=device)
    n_img = torch.full((B,), N_IMG, dtype=torch.int64, device=device)
    return (torch.from_numpy(ids).to(device), images, n_img,
            torch.from_numpy(att).to(device))


def run_text_slice(model, device: str, cases) -> dict:
    """`generate_texts` through the model: a capturing warm-up, a 1-token
    run (prefill time), the counted 32-token run and a second one; then a
    prefill whose logits are checked.  Raises on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.llama import KVCache

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)
    gen = TextGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=(),
                               pad_token_id=cfg.special.pad_token_id)

    def run(new_tokens):
        c = dataclasses.replace(gen, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate_texts(model, ids, images, n_img, att, c)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with capture(["ms_deform_attn_fwd"], cases):  # warm-up, real inputs
        run(2)
    check_sites("ms_deform_attn_fwd", cases)
    _, prefill_ms = run(1)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tokens, gen_ms = run(NEW_TOKENS)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens2, _ = run(NEW_TOKENS)

    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    expected = (2 * adapter.num_interactions + adapter.extra_extractors
                + n_cross * NEW_TOKENS)
    if launches["ms_deform_attn_fwd"] != expected:
        raise AssertionError(f"kernel 1 launches "
                             f"{launches['ms_deform_attn_fwd']} != {expected}")
    if launches["flash_attention_fwd"] != encoder_flash_calls(cfg):
        raise AssertionError(f"text slice flash launches "
                             f"{launches['flash_attention_fwd']} != "
                             f"{encoder_flash_calls(cfg)}")
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
                peak_gb=peak_gb)


def encoder_flash_calls(cfg) -> int:
    """Mask-free attention calls of one visual-tokenizer pass: the ViT's
    layers, the Q-Former's self-attentions and its cross-attentions."""
    p = cfg.visual.perceiver
    return (cfg.visual.encoder.vit.num_hidden_layers + p.num_hidden_layers
            + len(range(0, p.num_hidden_layers, p.cross_attention_frequency)))


def expected_image_launches(cfg, steps: int, rows: int) -> dict:
    """Each kernel's launches for `generate_image_inputs` + one
    `generate_images` call, derived from the config."""
    idc = cfg.image_decoder
    u, v = idc.unet, idc.vae
    n = len(u.block_out_channels)
    lpb = u.layers_per_block
    resnets = n * lpb + 2 + n * (lpb + 1)
    # SpatialTransformer widths: every down block but the last, the mid
    # block, every up block but the first
    widths = ([ch for ch in u.block_out_channels[:-1] for _ in range(lpb)]
              + [u.block_out_channels[-1]]
              + [ch for ch in reversed(u.block_out_channels[:-1])
                 for _ in range(lpb + 1)])
    geglu_blocks = sum(1 for ch in widths if ch <= 640)
    mmfs_blocks = len(u.down_residual_spec()[0]) + 1
    mini = idc.vae_decode_mini_bs
    chunks = rows // mini if 0 < mini < rows and rows % mini == 0 else 1
    nv = len(v.block_out_channels)
    vae_resnets = 2 + nv * (v.layers_per_block + 1)
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    adapter = cfg.visual.encoder
    return {
        "ms_deform_attn_fwd": (2 * adapter.num_interactions
                               + adapter.extra_extractors + n_cross),
        "ms_deform_attn_mi_fwd": mmfs_blocks * steps,
        "flash_attention_fwd": (encoder_flash_calls(cfg)
                                + cfg.llm.num_hidden_layers
                                + idc.perceiver.num_hidden_layers
                                + 2 * len(widths) * steps),
        "group_norm_silu_apply": ((2 * resnets + 1) * steps
                                  + (2 * vae_resnets + 1) * chunks),
        "geglu_fwd": geglu_blocks * steps,
    }


def run_image_slice(model, device: str, cases) -> dict:
    """`generate_image_inputs` + `generate_images` on the text slice's
    prompt: a capturing 2-step warm-up, the counted 25-step run and a
    second one (bit-identical), and two 2-step runs with and without the
    MMFS values.  Raises on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.generation.diffusion import generate_images

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)

    def run(steps, zero_mmfs=False):
        g = torch.Generator(device=device)
        g.manual_seed(SEED + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp = model.generate_image_inputs(ids, images, n_img, att)
        ctx, ctx_mask, values, mask = inp
        rows = torch.arange(B * cfg.max_num_images, device=device)
        rows = rows[(rows % cfg.max_num_images) < N_IMG]  # the target slots
        ctx, ctx_mask, values, mask = (x[rows] for x in inp)
        if zero_mmfs:
            values = torch.zeros_like(values)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = generate_images(model, ctx, ctx_mask, values, mask,
                              num_inference_steps=steps,
                              guidance_scale=GUIDANCE, generator=g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return out, mask, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    with capture([k for k in KERNELS if k != "ms_deform_attn_fwd"], cases):
        run(2)
    for name in KERNELS:
        check_sites(name, cases)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    images1, mask, inputs_ms, gen_ms = run(IMG_STEPS)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = images1.shape[0]
    expected = expected_image_launches(cfg, IMG_STEPS, rows)
    if launches != expected:
        raise AssertionError(f"image slice launches {launches} != "
                             f"{expected}")
    size = cfg.image_decoder.image_size
    if tuple(images1.shape) != (B * N_IMG, size, size, 3):
        raise AssertionError(f"images shape {tuple(images1.shape)}")
    if not torch.isfinite(images1).all():
        raise AssertionError("non-finite images")
    if float(images1.min()) < 0.0 or float(images1.max()) > 1.0:
        raise AssertionError("images outside [0, 1]")
    images2, _, _, _ = run(IMG_STEPS)
    if not torch.equal(images1, images2):
        raise AssertionError("two seeded image runs differ")
    live = mask[:, 0].bool()
    if int(live.sum()) != B * (N_IMG - 1):
        raise AssertionError(f"mmfs_mask {mask.flatten().tolist()}")
    with_mmfs, _, _, _ = run(2)
    without, _, _, _ = run(2, zero_mmfs=True)
    moved = (with_mmfs - without).abs().amax(dim=(1, 2, 3))
    if not bool((moved[live] > 0).all()):
        raise AssertionError(f"MMFS values do not reach the live rows: "
                             f"{moved.tolist()}")

    # one step's breakdown: the decode alone
    dec = model.image_decoder
    z = torch.randn((rows, cfg.image_decoder.latent_size,
                     cfg.image_decoder.latent_size, 4), device=device)
    with torch.inference_mode():
        vae_ms = time_ms(lambda: dec.vae_decode(z), runs=3)
    return dict(launches=launches, expected=expected, inputs_ms=inputs_ms,
                generate_ms=gen_ms,
                step_ms=(gen_ms - vae_ms) / IMG_STEPS, vae_decode_ms=vae_ms,
                total_ms=inputs_ms + gen_ms, peak_gb=peak_gb,
                mmfs_moved=moved.tolist(),
                image_mean=float(images1.mean()))


def profile_step(model, device: str) -> dict:
    """Device time by kernel over one denoise step (torch.profiler): the
    difference of a 2-step and a 1-step `generate_images` run."""
    import torch

    from mm_interleaved_tpu_torch.generation.diffusion import generate_images

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)
    inp = model.generate_image_inputs(ids, images, n_img, att)
    rows = torch.arange(B * cfg.max_num_images, device=device)
    rows = rows[(rows % cfg.max_num_images) < N_IMG]
    inp = [x[rows] for x in inp]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    per_kernel, launches = {}, [0, 0]
    for steps in (1, 2):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            generate_images(model, *inp, num_inference_steps=steps,
                            guidance_scale=GUIDANCE, generator=g)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = ev.cuda_time_total
            per_kernel.setdefault(ev.key, [0.0, 0.0])[steps - 1] += t / 1e3
            launches[steps - 1] += ev.count
    step = sorted(((k, v[1] - v[0]) for k, v in per_kernel.items()),
                  key=lambda kv: -kv[1])
    return dict(device_ms=sum(ms for _, ms in step),
                launches=launches[1] - launches[0],
                top=[dict(kernel=k[:80], ms=round(ms, 3))
                     for k, ms in step[:12]])


# --------------------------------------------------------------------------
# each kernel against its plain version


def _bound(flops, nbytes, rate):
    """(ops ms, bytes ms): the least times for the operations at the
    peak rate of their type and for the bytes at the memory rate."""
    return flops / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def work_deform(args, kw, out):
    """Bytes: the value texels the samples can touch (at most 4 corners of
    D channels per sample, at most the whole value), the locations, the
    weights and the output; operations: 4 FMAs per sample and channel (the
    attention weight folds into the corner weights once per sample)."""
    value, shapes, loc, w = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return 8 * samples * D, touched + _nbytes(loc, w, out), PEAK_FP32_FLOPS


def work_mi(args, kw, out):
    """As `work_deform`, over the live images only: a masked image is
    skipped and reads nothing."""
    value, delta, shapes, ref, off_q, wq, inv_base = args
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(shapes)
    live = (delta.reshape(Bv, H, n_img, L * P, 3)[..., 2] != 0).any(-1)
    live_bhn = int(live.sum())  # live (bv, h, n)
    samples = live_bhn * (B // Bv) * Lq * L * P  # per (b, q, h, n, l, p)
    touched = min(live_bhn * S * D, 4 * samples * D) * value.element_size()
    return 8 * samples * D, touched + _nbytes(delta, ref, off_q, wq, out), \
        PEAK_FP32_FLOPS


def work_flash(args, kw, out):
    import torch

    q, k, v = args
    B_, Tq, H, D = q.shape
    Tk = k.shape[1]
    pairs = B_ * Tq * Tk
    if kw.get("causal") or kw.get("q_segment_ids") is not None:
        dev = q.device
        ok = torch.ones((B_, Tq, Tk), dtype=torch.bool, device=dev)
        if kw.get("causal"):
            qi = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
            ok &= (torch.arange(Tk, device=dev)[None, :] <= qi)[None]
        if kw.get("q_segment_ids") is not None:
            ok &= (kw["q_segment_ids"][:, :, None]
                   == kw["kv_segment_ids"][:, None, :])
        pairs = int(ok.sum())
    flops = 4 * pairs * H * D
    return flops, _nbytes(q, k, v, out), PEAK_BF16_FLOPS


def work_gn(args, kw, out):
    x, w, b = args
    return 6 * x.numel(), _nbytes(x, w, b, out), PEAK_FP32_FLOPS


def work_geglu(args, kw, out):
    x, w1, b1, w2, b2 = args
    C = x.shape[-1]
    T = x.numel() // C
    Fh = w2.shape[1]
    return 6 * T * C * Fh, _nbytes(x, w1, b1, w2, b2, out), PEAK_BF16_FLOPS


WORK = {
    "ms_deform_attn_fwd": work_deform,
    "ms_deform_attn_mi_fwd": work_mi,
    "flash_attention_fwd": work_flash,
    "group_norm_silu_apply": work_gn,
    "geglu_fwd": work_geglu,
}
# positional arguments that take the compared dtype (the rest stay as
# captured: fp32 tables, shapes, segment ids, scalars)
CAST = {
    "ms_deform_attn_fwd": (0, 2, 3),
    "ms_deform_attn_mi_fwd": (0, 5),
    "flash_attention_fwd": (0, 1, 2),
    "group_norm_silu_apply": (0,),
    "geglu_fwd": (0, 1, 2, 3, 4),
}


def sdpa_call(args, kw):
    """One `scaled_dot_product_attention` call computing the same function
    (the yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (a.transpose(1, 2) for a in args)
    mask = None
    if kw.get("causal") or kw.get("q_segment_ids") is not None:
        Tq, Tk = q.shape[2], k.shape[2]
        dev = q.device
        mask = torch.ones((q.shape[0], 1, Tq, Tk), dtype=torch.bool,
                          device=dev)
        if kw.get("causal"):
            qi = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
            mask &= (torch.arange(Tk, device=dev)[None, :] <= qi)
        if kw.get("q_segment_ids") is not None:
            mask &= (kw["q_segment_ids"][:, None, :, None]
                     == kw["kv_segment_ids"][:, None, None, :])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=kw.get("scale"))


def compare_kernel(name, sites_cases) -> dict:
    """The kernel against its plain version on each captured call, in bf16
    and fp32, both timed; the bound of each call from its inputs."""
    import torch

    mod = kmod(name)
    kernel = getattr(mod, KERNELS[name]["kernel"])
    plain = getattr(mod, KERNELS[name]["plain"])
    sites = []
    for site in WANT_SITES[name]:
        args, kw = sites_cases[site]
        rec = dict(site=site, shapes=[list(a.shape) for a in args
                                      if isinstance(a, torch.Tensor)])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = tuple(x.to(dt) if i in CAST[name] else x
                      for i, x in enumerate(args))
            with torch.inference_mode():
                got = kernel(*a, **kw)
                want = plain(*a, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                if tag == "fp32":
                    # the same sums in another order; the GEGLU products
                    # reduce over K up to 2560
                    rel = 1e-4 if name == "geglu_fwd" else 1e-5
                    tol = rel * max(scale, 1.0)
                else:  # one bf16 ulp at the output's scale
                    tol = float(2.0 ** (np.floor(np.log2(max(scale, 1e-30)))
                                        - 7))
                if not err <= tol:
                    raise AssertionError(f"{name} {site} {tag}: kernel vs "
                                         f"plain {err} > {tol}")
                rec[f"max_abs_err_{tag}"] = err
                rec[f"tol_{tag}"] = tol
                rec[f"scale_{tag}"] = scale
                rec[f"ms_{tag}"] = time_ms(lambda: kernel(*a, **kw))
                rec[f"plain_ms_{tag}"] = time_ms(lambda: plain(*a, **kw))
                if tag == "bf16":
                    flops, nbytes, rate = WORK[name](a, kw, got)
                    rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes,
                                                            rate)
                    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                    rec["bound_by"] = ("operations" if rec["ops_ms"]
                                       > rec["bytes_ms"] else "bytes")
                    rec["flops"], rec["bytes"] = flops, nbytes
                    rec["library_ms"] = (time_ms(sdpa_call(a, kw))
                                         if name == "flash_attention_fwd"
                                         else None)
            del got, want
        sites.append(rec)
        log(f"kernel vs plain, {name} {site}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    return sites


def kernel_line(name, sites, launches) -> dict:
    """The kernel's entry of the ``{"kernels": [...]}`` line: times summed
    over its captured flagship call sites (bf16), errors over every site."""
    main = [s for s in sites if s["site"] != TINY]
    ops_ms = sum(s["ops_ms"] for s in main)
    bytes_ms = sum(s["bytes_ms"] for s in main)
    lib = [s["library_ms"] for s in main]
    info = KERNELS[name]
    return {
        "name": name,
        "route": "cuda",
        "source": f"mm_interleaved_tpu_torch/csrc/{info['source']}",
        "replaces": info["replaces"],
        "launches": launches,
        "max_abs_err": max(s["max_abs_err_bf16"] for s in sites),
        "max_abs_err_fp32": max(s["max_abs_err_fp32"] for s in sites),
        "ms": sum(s["ms_bf16"] for s in main),
        "plain_ms": sum(s["plain_ms_bf16"] for s in main),
        "bound_ms": sum(s["bound_ms"] for s in main),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "timing": "sum over the captured flagship call sites, bf16, median "
                  f"of {TIMING_RUNS} CUDA-event runs each",
        "sites": sites,
    }


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
    cases = {}
    ref = small_reference(cases)
    log(f"small reference (tiny, fp32, card vs CPU): {json.dumps(ref)}")

    # 4. the flagship model with its image decoder
    cfg = flagship_config(max_num_images=N_IMG)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_dec = sum(p.numel() for p in model.image_decoder.parameters())
    log(f"flagship: {n_params / 1e9:.3f} B params ({n_dec / 1e9:.3f} B in "
        f"the image decoder), bf16, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. the text slice
    res = run_text_slice(model, "cuda", cases)
    log(f"text slice: B={B} prompt={PROMPT_LEN} images/row={N_IMG} "
        f"new_tokens={NEW_TOKENS}: prefill (encode + LLM prefill + first "
        f"token) {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms']:.2f} ms/token, generate_texts "
        f"{res['gen_ms']:.1f} ms, peak memory {res['peak_gb']:.2f} GB, "
        f"launches {json.dumps(res['launches'])}")
    log(f"tokens[0][:16] = {res['tokens'][0, :16].tolist()}")

    # 6. the image slice
    img = run_image_slice(model, "cuda", cases)
    log(f"image slice: {B * N_IMG} images at "
        f"{cfg.image_decoder.image_size} px, {IMG_STEPS} DDPM steps, "
        f"guidance {GUIDANCE}: generate_image_inputs "
        f"{img['inputs_ms']:.1f} ms, denoise {img['step_ms']:.1f} ms/step, "
        f"VAE decode {img['vae_decode_ms']:.1f} ms, total "
        f"{img['total_ms']:.1f} ms, peak memory {img['peak_gb']:.2f} GB")
    log(f"image slice launches {json.dumps(img['launches'])} "
        f"(derived {json.dumps(img['expected'])}); MMFS moved the rows by "
        f"{img['mmfs_moved']}")
    prof = profile_step(model, "cuda")
    log(f"one denoise step (torch.profiler): device time "
        f"{prof['device_ms']:.1f} ms, {prof['launches']} kernel launches, "
        f"busy share {prof['device_ms'] / img['step_ms']:.2f} of the "
        f"unprofiled step; by kernel {json.dumps(prof['top'])}")
    del model
    torch.cuda.empty_cache()

    # 7. each kernel against its plain version at the captured shapes
    launches = dict(img["launches"])
    launches["ms_deform_attn_fwd"] = res["launches"]["ms_deform_attn_fwd"]
    lines = [kernel_line(name, compare_kernel(name, cases[name]),
                         launches[name]) for name in KERNELS]
    log(json.dumps({"kernels": lines}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
