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
   `scaled_dot_product_attention`;
8. training: (a) right after phase 3, one `Trainer` step of the tiny preset
   with its image decoder, fp32, on the card against the CPU with the same
   injected draws: loss within 1e-5 relative, every trainable gradient
   within 1e-4 of its scale, then one `Trainer` step at the default lr:
   the gradient norm within 1e-5 relative, Adam's moments within the
   gradients' tolerance, each master's update equal to AdamW's formula
   from the card's own moments (its first call of each backward kernel is
   the ``tiny`` site);
   (b) after phase 7, the flagship in its training form (frozen leaves as
   the JAX package freezes them, bf16 compute, fp32 masters in the
   optimizer, remat as configured, ``warmup_steps=0``: optax's first
   update is at count 0) on the phase 5-6 prompt with 512 px targets:
   step 1 twice from one state (the same loss, the gradient norm and the
   update within stated tolerances: the value gradient's fp32 atomics sum
   in varying order), then steps 2 and 3; finite metrics, frozen leaves
   bit-identical, every trainable group moved, every kernel's launch count
   equal to the count derived from the config, one step under
   `torch.profiler`; (c) each backward kernel against the plain version's
   autograd at every distinct training call shape and at ``tiny``, in
   bf16 and fp32, timed beside its bound and, for flash attention,
   autograd through `scaled_dot_product_attention`; flash attention's
   training forward (output and LSE) against attention in fp64 there;
9. the deformable-kernel benchmark (`mm_interleaved_tpu_torch.
   bench_deform_kernel.run`): the v1 and v4 kernels and kernel 1 at its
   unet and prefill cases, bf16, each timed (median of 25), the v1 and v4
   launch counts equal to the calls made; then v1 and v4 each against its
   plain version (bf16 within 2 ulps at the output's scale, fp32 within
   1e-5 of it) and against kernel 1 (bf16 2e-2, fp32 1e-4 of kernel 1's
   scale) at both cases, in bf16 and fp32, beside the bound of the
   function (`work_deform`, as kernel 1's) and the design's own operation
   count.

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
    "ms_deform_attn_bwd_value": dict(
        module="ms_deform_attn_cuda", kernel="ms_deform_attn_bwd_value_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:264 "
                 "_kernel_v5_bwd_dv"),
    "ms_deform_attn_bwd_loc_weight": dict(
        module="ms_deform_attn_cuda",
        kernel="ms_deform_attn_bwd_loc_weight_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:296 "
                 "_kernel_v5_bwd_dslab"),
    "flash_attention_bwd": dict(
        module="flash_attention", kernel="flash_attention_bwd",
        plain="attention_plain", source="flash_attention_bwd.cu",
        replaces="mm_interleaved_tpu/ops/flash_attention.py:19 "
                 "flash_attention (its backward: dkv, dq)"),
    "ms_deform_attn_v1_fwd": dict(
        module="ms_deform_attn_v1", kernel="ms_deform_attn_v1_cuda",
        plain="ms_deform_attn_v1_plain", source="ms_deform_attn_v1.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas.py:36 _kernel"),
    "ms_deform_attn_v4_fwd": dict(
        module="ms_deform_attn_v4", kernel="ms_deform_attn_v4_cuda",
        plain="ms_deform_attn_v4_plain", source="ms_deform_attn_v4.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py:157 "
                 "_kernel_v4"),
}
# the forward kernels of the inference phases and the backward kernels of
# the training phase
FORWARD = ("ms_deform_attn_fwd", "ms_deform_attn_mi_fwd",
           "flash_attention_fwd", "group_norm_silu_apply", "geglu_fwd")
BACKWARD = ("ms_deform_attn_bwd_value", "ms_deform_attn_bwd_loc_weight",
            "flash_attention_bwd")
# the benchmark's kernels (phase 9), by their formulation's name there
BENCH = {"ms_deform_attn_v1_fwd": "v1", "ms_deform_attn_v4_fwd": "v4"}
# the plain versions at the benchmark's unet case take tens of ms a call
PLAIN_RUNS = 5
TRAIN_STEPS = 3


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


def _site_deform_bwd(value, shapes, loc, w, grad_out):
    L, P, Q = loc.shape[3], loc.shape[4], loc.shape[1]
    if P == 4:
        return "injector" if L > 1 else "extractor"
    if L == 4:
        return f"unet_{int(round(Q ** 0.5))}px"
    return "mmfs_llm"


def _site_flash_bwd(q, k, v, grad_out, lse, **kw):
    return _site_flash(q, k, v, **kw)


SITES = {
    "ms_deform_attn_fwd": _site_deform,
    "ms_deform_attn_mi_fwd": _site_mi,
    "flash_attention_fwd": _site_flash,
    "group_norm_silu_apply": _site_gn,
    "geglu_fwd": _site_geglu,
    "ms_deform_attn_bwd_value": _site_deform_bwd,
    "ms_deform_attn_bwd_loc_weight": _site_deform_bwd,
    "flash_attention_bwd": _site_flash_bwd,
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
_DEFORM_TRAIN = ["injector", "extractor", "mmfs_llm", "unet_64px",
                 "unet_32px", "unet_16px", "unet_8px", TINY]
WANT_SITES.update({
    "ms_deform_attn_bwd_value": _DEFORM_TRAIN,
    "ms_deform_attn_bwd_loc_weight": _DEFORM_TRAIN,
    "flash_attention_bwd": WANT_SITES["flash_attention_fwd"],
})


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
    if any(counts[n] == 0 for n in FORWARD):
        raise AssertionError(f"tiny card run missed a kernel: {counts}")
    return dict(logits_max_abs_err=err, logits_scale=scale,
                top2_margin=margin, tokens_equal=torch.equal(tok_gpu, tok_cpu),
                image_inputs_max_abs_err=inputs_err,
                images_max_abs_err=img_err, launches=counts)


def tiny_train_batch(cfg, rng):
    """The small reference's prompt as a training batch (two rows, two
    images in one document each, 16 px targets) with the image decoder's
    draws for its 6 image slots (one uncond drop)."""
    import torch

    s = cfg.special
    row = [s.bos_token_id, 5, s.soi_token_id] + [s.image_token_id] * \
        cfg.num_img_token + [7, 8, s.soi_token_id] + \
        [s.image_token_id] * cfg.num_img_token + [9]
    ids = torch.tensor([row, [s.pad_token_id] + row[:-1]])
    idc = cfg.image_decoder
    n = 2 * cfg.max_num_images
    lat = (n, idc.latent_size, idc.latent_size, idc.vae.latent_channels)
    f32 = np.float32
    batch = dict(
        text_ids=ids, attention_mask=(ids != s.pad_token_id).int(),
        image_tensors=torch.from_numpy(
            rng.rand(2, cfg.max_num_images, 56, 56, 3).astype(f32)),
        num_image_per_seq=torch.tensor([2, 2]),
        image_tensors_dec=torch.from_numpy(
            rng.rand(2, cfg.max_num_images, idc.image_size, idc.image_size,
                     3).astype(f32)))
    draws = dict(
        vae_noise=torch.from_numpy(rng.randn(*lat).astype(f32)),
        noise=torch.from_numpy(rng.randn(*lat).astype(f32)),
        timesteps=torch.from_numpy(
            rng.randint(0, idc.schedule.num_train_timesteps, n)),
        uncond_drop=torch.arange(n) == 1)
    return batch, draws


def to_dev(d, device):
    return {k: v.to(device) for k, v in d.items()}


def grad_tolerances(want: dict) -> dict:
    """1e-4 x each leaf's scale, the larger of its largest gradient and 1e-3
    of the largest of all (a leaf whose exact gradient vanishes holds
    rounding noise only)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: 1e-4 * max(float(g.abs().max()), 1e-3 * top)
            for n, g in want.items()}


def small_training_reference(cases) -> dict:
    """One training step of the tiny preset with its image decoder, fp32:
    the card (kernels) against the CPU (plain versions) from one seeded
    model and one set of draws.  Keeps the first inputs of each backward
    kernel as its ``TINY`` site.  Then one `Trainer` step on each, at the
    default lr, held by `adamw_check`."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = tiny_config()
    optim = OptimConfig(warmup_steps=0)
    cpu = build_model(cfg, "cpu", torch.float32, seed=SEED, optim=optim)
    perturb_zero_inits(cpu, SEED + 1)
    gpu = copy.deepcopy(cpu).cuda()
    batch, draws = tiny_train_batch(cfg, np.random.RandomState(SEED + 2))

    def loss_and_grads(model, device):
        out = model(**to_dev(batch, device), **to_dev(draws, device))
        out["loss"].backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.requires_grad}
        for p in model.parameters():
            p.grad = None
        return {k: float(v.detach()) for k, v in out.items()}, grads

    want, g_cpu = loss_and_grads(cpu, "cpu")
    reset_counts()
    with capture(list(BACKWARD), cases, site=TINY):
        got, g_gpu = loss_and_grads(gpu, "cuda")
    counts = read_counts()
    if any(counts[n] == 0 for n in BACKWARD):
        raise AssertionError(f"tiny training step missed a kernel: {counts}")
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    if not loss_err <= 1e-5:
        raise AssertionError(f"tiny losses card {got} vs CPU {want}")
    tol = grad_tolerances(g_cpu)
    grad_err = {n: float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()}
    bad = [n for n in g_cpu if not grad_err[n] <= tol[n]]
    if bad:
        raise AssertionError(f"tiny gradients card vs CPU: "
                             f"{[(n, grad_err[n], tol[n]) for n in bad[:5]]}")
    tcfg = TrainerConfig(optim=optim)
    t_cpu, t_gpu = Trainer(cpu, tcfg, "cpu"), Trainer(gpu, tcfg, "cuda")
    x0 = [x.detach().clone() for x in t_cpu.optimizer.masters]
    m_cpu = t_cpu.train_step(batch, [draws])
    m_gpu = t_gpu.train_step(to_dev(batch, "cuda"), [to_dev(draws, "cuda")])
    gn_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    if not gn_err <= 1e-5:
        raise AssertionError(f"tiny grad norm card {m_gpu['grad_norm']} vs "
                             f"CPU {m_cpu['grad_norm']}")
    adam = adamw_check(t_cpu.optimizer, t_gpu.optimizer, x0)
    return dict(losses_cpu=want, losses_card=got, loss_max_rel_err=loss_err,
                grad_max_abs_err=max(grad_err.values()),
                grad_max_err_over_tol=max(grad_err[n] / tol[n]
                                          for n in g_cpu),
                grad_norm_rel_err=gn_err, metrics_cpu=m_cpu,
                metrics_card=m_gpu, launches=counts, **adam)


def adamw_check(opt_cpu, opt_gpu, x0) -> dict:
    """One AdamW step on the card against the CPU from the same masters
    ``x0``: (1) the moments m and v within `grad_tolerances` of each leaf's
    (they are the clipped gradients, scaled and squared); (2) the card's
    update equal to AdamW's formula in fp64 from the card's own moments,
    within 2 fp32 ulps of the master plus 1e-6 of the step (a flipped sign,
    a wrong bias correction, lr or weight decay moves a master by far more).
    The update's difference from the CPU's, over the norm of the CPU's, is
    reported and not checked: a leaf whose exact gradient vanishes (a key
    bias before a softmax) holds rounding noise, and Adam turns noise into
    steps of +-lr with the noise's sign."""
    c = opt_cpu.cfg
    names = opt_cpu.names
    for key in ("m", "v"):
        want = dict(zip(names, getattr(opt_cpu, key)))
        tol = grad_tolerances(want)
        got = {n: x.cpu() for n, x in zip(names, getattr(opt_gpu, key))}
        bad = [(n, float((got[n] - w).abs().max()), tol[n])
               for n, w in want.items()
               if not float((got[n] - w).abs().max()) <= tol[n]]
        if bad:
            raise AssertionError(f"tiny AdamW {key} card vs CPU: {bad[:5]}")
    lr = opt_cpu.schedule(0)
    bc1, bc2 = 1.0 - c.beta1, 1.0 - c.beta2
    arith, diff2, norm2 = 0.0, 0.0, 0.0
    for i, n in enumerate(names):
        scale, wd = opt_gpu.group_of[i]
        wd = c.weight_decay if wd is None else wd
        x = x0[i].double()
        m, v = opt_gpu.m[i].cpu().double(), opt_gpu.v[i].cpu().double()
        u = (m / bc1) / ((v / bc2).sqrt() + c.eps) + wd * x
        want = x - lr * scale * u
        got = opt_gpu.masters[i].cpu().double()
        tol = (2.0 ** -22 * float(want.abs().max())
               + 1e-6 * lr * scale * float(u.abs().max()))
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"tiny AdamW update of {n} on the card: "
                                 f"{err} from the formula > {tol}")
        arith = max(arith, err / tol)
        d_cpu = opt_cpu.masters[i].double() - x
        diff2 += float((got - x - d_cpu).pow(2).sum())
        norm2 += float(d_cpu.pow(2).sum())
    return dict(adamw_lr=lr, adamw_max_err_over_tol=arith,
                update_rel_diff_vs_cpu=(diff2 / norm2) ** 0.5)


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
        # inference records no graph: no backward kernel runs; the
        # benchmark's kernels serve the benchmark alone
        **{name: 0 for name in (*BACKWARD, *BENCH)},
    }


def unet_counts(cfg):
    """(ResnetBlocks, SpatialTransformers, MMFS blocks) of the UNet."""
    u = cfg.image_decoder.unet
    n, lpb = len(u.block_out_channels), u.layers_per_block
    return (n * lpb + 2 + n * (lpb + 1), (n - 1) * lpb + 1 + (n - 1) * (lpb + 1),
            len(u.down_residual_spec()[0]) + 1)


def expected_train_launches(cfg, images: int) -> dict:
    """Each kernel's launches in one training step (one micro-batch),
    derived from the config.  Every deformable and mask-free attention call
    of the step needs its backward (the adapter, the Q-Former, the LLM's
    MMFS and the UNet train, and each feeds the calls after it); remat
    runs the forward of each remat'd LLM layer and UNet block again in the
    backward; the VAE encodes without gradient; the fused GEGLU and the
    factorised MMFS kernel serve inference alone."""
    idc = cfg.image_decoder
    resnets, transformers, mmfs_blocks = unet_counts(cfg)
    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    llm_r = 2 if cfg.llm.remat else 1
    unet_r = 2 if idc.unet.remat else 1
    mini = idc.vae_encode_mini_bs
    chunks = images // mini if 0 < mini < images and images % mini == 0 else 1
    vae = idc.vae
    enc_resnets = len(vae.block_out_channels) * vae.layers_per_block + 2
    deform = 2 * adapter.num_interactions + adapter.extra_extractors \
        + n_cross + mmfs_blocks
    flash = (encoder_flash_calls(cfg) + cfg.llm.num_hidden_layers
             + idc.perceiver.num_hidden_layers + 2 * transformers)
    return {
        "ms_deform_attn_fwd": deform + (llm_r - 1) * n_cross,
        "ms_deform_attn_mi_fwd": 0,
        "flash_attention_fwd": flash
        + (llm_r - 1) * cfg.llm.num_hidden_layers
        + (unet_r - 1) * 2 * transformers,
        "group_norm_silu_apply": (2 * resnets * unet_r + 1
                                  + (2 * enc_resnets + 1) * chunks),
        "geglu_fwd": 0,
        "ms_deform_attn_bwd_value": deform,
        "ms_deform_attn_bwd_loc_weight": deform,
        "flash_attention_bwd": flash,
        **{name: 0 for name in BENCH},
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

    with capture([k for k in FORWARD if k != "ms_deform_attn_fwd"], cases):
        run(2)
    for name in FORWARD:
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
# the flagship training step


def train_inputs(cfg, device):
    """The phase 5-6 prompt as a training batch, with the 512 px targets of
    its image decoder."""
    import torch

    ids, images, n_img, att = prompt_inputs(cfg, device)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 3)
    size = cfg.image_decoder.image_size
    dec = torch.rand((B, N_IMG, size, size, 3), generator=g, device=device)
    return dict(text_ids=ids, image_tensors=images, num_image_per_seq=n_img,
                attention_mask=att, image_tensors_dec=dec)


def run_training(device: str, cases) -> dict:
    """The flagship's training form, 3 AdamW steps on the prompt: step 1
    twice from one state (the first capturing the backward kernels'
    inputs), then steps 2 and 3, the last under `torch.profiler`.  Raises
    on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = flagship_config(max_num_images=N_IMG)
    optim = OptimConfig(warmup_steps=0)
    t0 = time.perf_counter()
    model = build_model(cfg, device, torch.bfloat16, seed=SEED, optim=optim)
    perturb_zero_inits(model, SEED + 1)
    trainer = Trainer(model, TrainerConfig(optim=optim), device)
    opt = trainer.optimizer
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    frozen = {n: p.detach().to("cpu", copy=True) for n, p in params.items()
              if not p.requires_grad}
    start = [p.detach().to("cpu", copy=True) for p in opt.params]
    n_train = sum(p.numel() for p in opt.params)
    log(f"flagship training form: {n_train / 1e9:.3f} B trainable (fp32 "
        f"masters), {sum(t.numel() for t in frozen.values()) / 1e9:.3f} B "
        f"frozen, bf16 compute, remat llm={cfg.llm.remat} "
        f"unet={cfg.image_decoder.unet.remat}, built in {build_s:.1f} s")
    batch = train_inputs(cfg, device)

    def step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        return m, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats()
    with capture(list(BACKWARD), cases):
        m_first, _ = step()
    for name in BACKWARD:
        check_sites(name, cases)
    first = [x.detach().to("cpu", copy=True) for x in opt.masters]
    # back to the starting state: zero moments and count; the masters were
    # the bf16 parameters made fp32
    with torch.no_grad():
        for p, x0, x, m, v in zip(opt.params, start, opt.masters, opt.m,
                                  opt.v):
            p.copy_(x0)
            x.copy_(x0)
            m.zero_()
            v.zero_()
    opt.count, trainer.step = 0, 0
    reset_counts()
    m1, ms1 = step()
    launches = read_counts()
    images = B * N_IMG
    expected = expected_train_launches(cfg, images)
    if launches != expected:
        raise AssertionError(f"training launches {launches} != {expected}")
    # the two runs of step 1
    upd_diff = upd_norm = 0.0
    for x0, x1, x in zip(start, first, opt.masters):
        x0 = x0.to(device).float()
        d1 = x1.to(device) - x0
        d2 = x - x0
        upd_diff += float((d2 - d1).pow(2).sum())
        upd_norm += float(d1.pow(2).sum())
    upd_rel = (upd_diff / upd_norm) ** 0.5
    loss_rel = abs(m1["loss"] - m_first["loss"]) / abs(m_first["loss"])
    gn_rel = abs(m1["grad_norm"] - m_first["grad_norm"]) / m_first["grad_norm"]
    if not (loss_rel <= 1e-6 and gn_rel <= 1e-3 and upd_rel <= 1e-2):
        raise AssertionError(f"two runs of step 1 differ: loss {loss_rel}, "
                             f"grad norm {gn_rel}, update {upd_rel}")
    m2, ms2 = step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        m3, ms3 = step()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = [m1, m2, m3]
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training metrics {m}")
    for n, t in frozen.items():
        if not torch.equal(params[n].detach(), t.to(device)):
            raise AssertionError(f"frozen parameter {n} changed")
    moved = {}  # by the fp32 masters: a bf16 weight moves by whole ulps
    for lab, x, x0 in zip(opt.labels, opt.masters, start):
        d = float((x - x0.to(device).float()).abs().max())
        moved[lab] = max(moved.get(lab, 0.0), d)
    if not all(d > 0 for d in moved.values()):
        raise AssertionError(f"a trainable group did not move: {moved}")
    per_kernel, n_launch = {}, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + t / 1e3
        n_launch += ev.count
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    device_ms = sum(per_kernel.values())
    del model, trainer, opt, params
    torch.cuda.empty_cache()
    return dict(metrics=metrics, step_ms=[ms1, ms2, ms3],
                first_run=m_first, loss_rel=loss_rel, grad_norm_rel=gn_rel,
                update_rel=upd_rel, launches=launches, expected=expected,
                peak_gb=peak_gb, moved=moved, trainable=n_train,
                device_ms=device_ms, busy=device_ms / ms2,
                profiled_launches=n_launch,
                top=[dict(kernel=k[:80], ms=round(v, 3)) for k, v in top[:14]])


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


def sdpa_call(args, kw, transposed=False):
    """One `scaled_dot_product_attention` call computing the same function
    (the yardstick; the port never calls it); ``args`` are ``[B, T, H,
    D]``, or ``[B, H, T, D]`` when ``transposed``."""
    import torch.nn.functional as F

    q, k, v = (args[:3] if transposed
               else (a.transpose(1, 2) for a in args[:3]))
    mask = None
    if kw.get("causal") or kw.get("q_segment_ids") is not None:
        # the helper takes [B, T, H, D]
        mask = attention_allowed(q.transpose(1, 2), k.transpose(1, 2),
                                 kw.get("causal", False),
                                 kw.get("q_segment_ids"),
                                 kw.get("kv_segment_ids"))
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


def work_deform_bwd_value(args, kw, out):
    """Bytes: dOut, the locations and weights read, the value gradient
    written once; operations: 8 per sample and channel (the corner weights
    times w * dOut, and the four adds)."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    samples = N * Q * H * L * P
    return (8 * samples * value.shape[3],
            _nbytes(grad_out, loc, w, value), PEAK_FP32_FLOPS)


def work_deform_bwd_loc_weight(args, kw, out):
    """Bytes: the corners the samples can touch (as `work_deform`), dOut,
    the locations and weights read, their gradients written; operations: 8
    per sample and channel (the four corner dot products)."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return (8 * samples * D, touched + _nbytes(grad_out, loc, w, *out),
            PEAK_FP32_FLOPS)


def work_flash_bwd(args, kw, out):
    """Operations: 10 per unmasked (query, key) pair, head and channel (the
    recomputed S, dP, and the dV, dK, dQ products); bytes: q, k, v, dOut
    and the LSE read, dq, dk, dv written."""
    q, k, v, grad_out, lse = args
    flops, _, rate = work_flash((q, k, v), kw, q)
    return flops // 4 * 10, _nbytes(q, k, v, grad_out, lse, *out), rate


WORK.update({
    "ms_deform_attn_bwd_value": work_deform_bwd_value,
    "ms_deform_attn_bwd_loc_weight": work_deform_bwd_loc_weight,
    "flash_attention_bwd": work_flash_bwd,
})


def _backward_case(name, args, kw, dt):
    """The captured inputs in ``dt`` (flash attention's LSE recomputed by
    the forward kernel from the cast q, k, v), the number of them the plain
    forward takes, the positions the gradient is taken for, that plain
    forward, and the training forward's outputs (flash attention; else
    None)."""
    import torch

    from mm_interleaved_tpu_torch.ops import flash_attention as fa
    from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk

    if name == "flash_attention_bwd":
        q, k, v, grad_out, _ = args
        q, k, v, grad_out = (x.to(dt) for x in (q, k, v, grad_out))
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        return ((q, k, v, grad_out, lse), 3, (0, 1, 2),
                lambda *x: fa.attention_plain(*x, **kw),
                dict(out=out, lse=lse))
    value, shapes, loc, w, grad_out = args
    value, loc, w, grad_out = (x.to(dt) for x in (value, loc, w, grad_out))
    wrt = (0,) if name == "ms_deform_attn_bwd_value" else (2, 3)
    return ((value, shapes, loc, w, grad_out), 4, wrt,
            dk.ms_deform_attn_plain, None)


def _grad_timer(fn, a, wrt, grad_out):
    """One backward through ``fn``'s graph on ``a`` (built once)."""
    import torch

    with torch.enable_grad():
        ins = [x.detach().requires_grad_(i in wrt) if hasattr(x, "detach")
               else x for i, x in enumerate(a)]
        out = fn(*ins)
    wanted = [ins[i] for i in wrt]
    return lambda: torch.autograd.grad(out, wanted, grad_out,
                                       retain_graph=True)


def sdpa_grad_timer(a, kw):
    """Autograd through `scaled_dot_product_attention` on the same inputs
    (the yardstick; the port never calls it)."""
    import torch

    q, k, v, grad_out, _ = a
    ins = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = sdpa_call(ins, kw, transposed=True)()
    return lambda: torch.autograd.grad(out, ins, grad_out.transpose(1, 2),
                                       retain_graph=True)


def attention_allowed(q, k, causal=False, q_segment_ids=None,
                      kv_segment_ids=None):
    """The pairs a query may attend to, ``[B, 1, Tq, Tk]`` bool, or None."""
    import torch

    tq, tk = q.shape[1], k.shape[1]
    ok = torch.ones((q.shape[0], 1, tq, tk), dtype=torch.bool,
                    device=q.device)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ok &= torch.arange(tk, device=q.device)[None, :] <= qi
    if q_segment_ids is not None:
        ok &= (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
    return ok


def attention_f64(q, k, v, causal=False, scale=None, q_segment_ids=None,
                  kv_segment_ids=None, with_lse=False):
    """Attention in the inputs' dtype throughout (fp64 for the reference
    of the flash backward), with the plain version's masks; with
    ``with_lse`` also the log-sum-exp ``[B, H, Tq]`` of the scaled logits."""
    import torch

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ok = attention_allowed(q, k, causal, q_segment_ids, kv_segment_ids)
    logits = logits.masked_fill(~ok, torch.finfo(torch.float32).min)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return (out, torch.logsumexp(logits, dim=-1)) if with_lse else out


def check_training_forward(a, kw, fwd, tag, fails) -> dict:
    """The training forward's outputs (the forward kernel that also writes
    the LSE) against attention in fp64 on the same inputs; a miss is
    appended to ``fails``.  The output within one bf16 ulp at its scale
    (bf16) or 1e-5 of the largest |v| (at least 1; fp32); the LSE within
    1e-5 of its largest magnitude (at least 1); a row whose keys are all
    masked carries -FLT_MAX there and in the reference's lowest-finite
    fill."""
    import torch

    q, k, v = (x.double() for x in a[:3])
    out_ref, lse_ref = attention_f64(q, k, v, with_lse=True, **kw)
    scale = float(out_ref.abs().max())
    tol = (float(2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7))
           if tag == "bf16" else 1e-5 * max(float(v.abs().max()), 1.0))
    dead = lse_ref < -1e30
    lse = fwd["lse"].double()
    if not torch.equal(dead, lse < -1e30):
        fails.append(f"flash training forward {tag}: fully masked rows "
                     "differ")
    lse_ref = lse_ref.masked_fill(dead, 0.0)
    checks = [("out", fwd["out"], out_ref, tol),
              ("lse", lse.masked_fill(dead, 0.0), lse_ref,
               1e-5 * max(float(lse_ref.abs().max()), 1.0))]
    res = {}
    for key, t, ref, tol in checks:
        err = float((t.double() - ref).abs().max())
        if not err <= tol:
            fails.append(f"flash training forward {tag} {key}: {err} > {tol}")
        res[key], res[f"{key}_tol"] = err, tol
    return res


def delta_reading(a, kw, out, dq_ref) -> dict:
    """Why delta comes from P and dP: dQ recomputed in fp32 torch from the
    kernels' own LSE, with P = exp(S * scale - LSE) and delta taken as
    FlashAttention-2 takes it, rowsum(dO * O) from the forward's output
    ``out``, or as the kernels take it, sum P dP / sum P; each one's
    largest error against the fp64 dQ, beside how far sum P strays from
    1."""
    import torch

    q, k, v, g, lse = (x.float() for x in a)
    scale = kw.get("scale") or q.shape[-1] ** -0.5
    ok = attention_allowed(q, k, kw.get("causal", False),
                           kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    p_sum = p.sum(-1)
    live = p_sum > 0
    deltas = dict(from_o=(g * out.float()).sum(-1).permute(0, 2, 1),
                  from_p=(p * dp).sum(-1) / p_sum.clamp_min(1e-30))
    res = dict(p_sum_max_dev=float((p_sum - 1).abs()[live].max()))
    for key, d in deltas.items():
        ds = p * (dp - d[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
        res[f"dq_err_delta_{key}"] = float((dq.double() - dq_ref).abs().max())
        del ds, dq
    return res


def compare_backward(name, sites_cases) -> list:
    """Each backward kernel at each captured site, its inputs rounded to
    bf16 or kept fp32, against autograd through a reference on the same
    inputs: the plain version in fp32 for the deformable kernels, attention
    in fp64 for flash attention (with `check_training_forward` on its
    forward and `delta_reading` on its dQ).  Tolerance:
    the larger of the base and, for flash attention, 4x the error the
    plain version makes itself in the same dtype against the fp64
    reference (dQ is a small difference of large terms where the keys
    share a common component, as the ViT's and the Q-Former's do).  Base,
    fp32: 1e-5 x each gradient's scale (the same sums in another order);
    bf16: a few ulps at the scale, 2 for the deformable kernels, which
    round only their outputs, 4 for flash attention, which also rounds P
    and dS to bf16 for dV and dK.  Each site's failures are gathered and
    the phase fails after the last site.  Timed beside the plain version's
    backward in the same dtype."""
    import torch

    from mm_interleaved_tpu_torch.ops import flash_attention as fa

    kernel = kernel_of(name)
    flash = name == "flash_attention_bwd"
    ulps = 4 if flash else 2
    sites, fails = [], []
    for site in WANT_SITES[name]:
        args, kw = sites_cases[site]
        kw = {k: v for k, v in kw.items() if k != "return_lse"}
        rec = dict(site=site, shapes=[list(x.shape) for x in args
                                      if isinstance(x, torch.Tensor)])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a, n_in, wrt, fn, fwd = _backward_case(name, args, kw, dt)
            if flash:
                rec[f"forward_{tag}"] = check_training_forward(a, kw, fwd, tag,
                                                              fails)
            got = kernel(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            grad_out = a[3] if flash else a[4]
            ref_dt = torch.float64 if flash else torch.float32
            ref_fn = ((lambda *x: attention_f64(*x, **kw)) if flash else fn)
            with torch.enable_grad():
                ins = [x.detach().to(ref_dt).requires_grad_(i in wrt)
                       if isinstance(x, torch.Tensor) else x
                       for i, x in enumerate(a[:n_in])]
                ref = torch.autograd.grad(ref_fn(*ins),
                                          [ins[i] for i in wrt],
                                          grad_out.to(ref_dt))
            plain = (fa.attention_plain_backward(*a[:3], grad_out, **kw)
                     if flash else None)
            torch.cuda.synchronize()
            errs, tols, scales, plain_errs = [], [], [], []
            for i, (g, r) in enumerate(zip(got, ref)):
                err = float((g.double() - r).abs().max())
                scale = float(r.abs().max())
                tol = (1e-5 * scale if tag == "fp32"
                       else float(ulps * 2.0 ** (
                           np.floor(np.log2(max(scale, 1e-30))) - 7)))
                if plain is not None:
                    plain_errs.append(float(
                        (plain[i].double() - r).abs().max()))
                    tol = max(tol, 4 * plain_errs[-1])
                if not err <= tol:
                    fails.append(f"{name} {site} {tag}: kernel vs plain "
                                 f"{err} > {tol}")
                errs.append(err), tols.append(tol), scales.append(scale)
            if flash:
                rec[f"plain_errs_{tag}"] = plain_errs
                rec[f"delta_reading_{tag}"] = delta_reading(
                    a, kw, fwd["out"], ref[0])
            rec[f"max_abs_err_{tag}"] = max(errs)
            rec[f"errs_{tag}"] = errs
            rec[f"tol_{tag}"] = tols
            rec[f"scale_{tag}"] = scales
            rec[f"ms_{tag}"] = time_ms(lambda: kernel(*a, **kw))
            rec[f"plain_ms_{tag}"] = time_ms(_grad_timer(fn, a[:n_in], wrt,
                                                         grad_out))
            if tag == "bf16":
                flops, nbytes, rate = WORK[name](a, kw, got)
                rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes, rate)
                rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                rec["bound_by"] = ("operations" if rec["ops_ms"]
                                   > rec["bytes_ms"] else "bytes")
                rec["flops"], rec["bytes"] = flops, nbytes
                rec["library_ms"] = (time_ms(sdpa_grad_timer(a, kw))
                                     if name == "flash_attention_bwd"
                                     else None)
            del got, ref, plain, a, fwd
        sites.append(rec)
        log(f"kernel vs plain, {name} {site}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return sites


def kernel_line(name, sites, launches,
                timing="sum over the captured flagship call sites") -> dict:
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
        "timing": f"{timing}, bf16, median of {TIMING_RUNS} CUDA-event "
                  "runs each",
        "sites": sites,
    }


def design_ops(name, args) -> dict:
    """The operations the kernel's own design performs (beside the bound,
    which counts the function's work and does not change with the
    formulation): v4 builds Q * sum(h*w) * P hat products per (n, h) and
    multiplies A (Q x h*w) by V (h*w x D) on the tensor cores; v1 reads 2
    rows by 2 columns per sample and channel, with 6 FMAs (4 row blends, 2
    column weights)."""
    value, shapes, loc, w = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    texels = sum(h * w_ for h, w_ in shapes)
    if name == "ms_deform_attn_v4_fwd":
        return dict(hat_products=N * H * Q * texels * P,
                    tensor_flops=2 * N * H * Q * texels * D)
    samples = N * Q * H * L * P
    return dict(texel_reads=4 * samples * D, flops=12 * samples * D)


def compare_bench(name, res) -> list:
    """Phase 9's checks of one benchmark kernel at each of the benchmark's
    cases, on its inputs (bf16 values) and with the values in fp32: the
    kernel against its plain version (bf16 within 2 ulps at the output's
    scale: only the order of the sums differs; fp32 within 1e-5 of the
    scale) and against kernel 1, the same function in another formulation
    (bf16 within 2e-2 of kernel 1's scale, as tests/test_pallas_kernel.py
    allows v4 against the gather; fp32 1e-4).  The bf16 time is the
    benchmark's own; the fp32 time and the plain versions' (median of
    PLAIN_RUNS) are taken here.  Every failure is gathered; the phase fails
    after the last case."""
    import torch

    mod = kmod(name)
    kernel = getattr(mod, KERNELS[name]["kernel"])
    plain = getattr(mod, KERNELS[name]["plain"])
    kernel1 = kernel_of("ms_deform_attn_fwd")
    form = BENCH[name]
    sites, fails = [], []
    for case, args in res["inputs"].items():
        row = next(r for r in res["rows"]
                   if r["case"] == case and r["formulation"] == form)
        rec = dict(site=case, shapes=[list(x.shape) for x in args
                                      if isinstance(x, torch.Tensor)],
                   ms_bf16=row["ms"])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = (args[0].to(dt),) + tuple(args[1:])
            with torch.inference_mode():
                got = (res["outputs"][case][form] if tag == "bf16"
                       else kernel(*a))
                want = plain(*a)
                ref = kernel1(*a)
                torch.cuda.synchronize()
                got, want, ref = got.float(), want.float(), ref.float()
                scale = float(want.abs().max())
                scale1 = float(ref.abs().max())
                err = float((got - want).abs().max())
                err1 = float((got - ref).abs().max())
            if tag == "bf16":
                tol = float(2 * 2.0 ** (np.floor(np.log2(max(scale, 1e-30)))
                                        - 7))
                tol1 = 2e-2 * scale1
            else:
                tol, tol1 = 1e-5 * scale, 1e-4 * scale1
            if not err <= tol:
                fails.append(f"{name} {case} {tag}: kernel vs plain {err} > "
                             f"{tol}")
            if not err1 <= tol1:
                fails.append(f"{name} {case} {tag}: kernel vs kernel 1 "
                             f"{err1} > {tol1}")
            rec.update({f"max_abs_err_{tag}": err, f"tol_{tag}": tol,
                        f"scale_{tag}": scale,
                        f"err_vs_kernel1_{tag}": err1,
                        f"tol_vs_kernel1_{tag}": tol1})
            with torch.inference_mode():
                if tag == "fp32":
                    rec["ms_fp32"] = time_ms(lambda: kernel(*a))
                rec[f"plain_ms_{tag}"] = time_ms(lambda: plain(*a),
                                                 PLAIN_RUNS)
            if tag == "bf16":
                flops, nbytes, rate = work_deform(a, {}, got.to(dt))
                rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes, rate)
                rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                rec["bound_by"] = ("operations" if rec["ops_ms"]
                                   > rec["bytes_ms"] else "bytes")
                rec["flops"], rec["bytes"] = flops, nbytes
                rec["library_ms"] = None
                rec["design_ops"] = design_ops(name, a)
            del got, want, ref
        sites.append(rec)
        log(f"kernel vs plain and kernel 1, {name} {case}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return sites


def run_bench_phase() -> list:
    """Phase 9: the benchmark entry point on the card with every count at
    0 just before it, its v1, v4 and kernel-1 launches equal to the calls
    it made, then `compare_bench` for v1 and v4; returns their entries of
    the kernels line."""
    from mm_interleaved_tpu_torch import bench_deform_kernel as bench

    reset_counts()
    res = bench.run("cuda")
    got = read_counts()
    for row in res["rows"]:
        log(f"bench_deform_kernel: {json.dumps(row)}")
    want = {name: res["calls"][form] for name, form in BENCH.items()}
    want["ms_deform_attn_fwd"] = res["calls"]["kernel1"]
    for name, n in want.items():
        if n == 0 or got[name] != n:
            raise AssertionError(f"{name}: {got[name]} launches in the "
                                 f"benchmark, {n} calls made")
    log(f"benchmark launches {json.dumps(got)}")
    return [kernel_line(name, compare_bench(name, res), got[name],
                        timing="sum over the benchmark's unet and prefill "
                               "cases")
            for name in BENCH]


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
    tref = small_training_reference(cases)
    log(f"small training reference (tiny, fp32, one AdamW step, card vs "
        f"CPU): {json.dumps(tref)}")

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
                         launches[name]) for name in FORWARD]

    # 8. the flagship training step, then the backward kernels against
    # their plain versions at the captured shapes
    tr = run_training("cuda", cases)
    m = tr["metrics"]
    log(f"training: B={B} rows of {PROMPT_LEN} tokens, {B * N_IMG} target "
        f"images at {cfg.image_decoder.image_size} px, {TRAIN_STEPS} AdamW "
        f"steps: {[round(x, 1) for x in tr['step_ms']]} ms/step, peak "
        f"memory {tr['peak_gb']:.2f} GB; loss {[x['loss'] for x in m]}, "
        f"loss_txt {[x['loss_txt'] for x in m]}, loss_img "
        f"{[x['loss_img'] for x in m]}, grad_norm "
        f"{[x['grad_norm'] for x in m]}")
    log(f"training step 1 twice: loss rel {tr['loss_rel']:.2e}, grad norm "
        f"rel {tr['grad_norm_rel']:.2e}, update rel {tr['update_rel']:.2e}; "
        f"groups moved {json.dumps(tr['moved'])}; launches "
        f"{json.dumps(tr['launches'])} (derived {json.dumps(tr['expected'])})")
    log(f"one training step (torch.profiler): device time "
        f"{tr['device_ms']:.1f} ms, {tr['profiled_launches']} kernel "
        f"launches, busy share {tr['busy']:.2f} of the unprofiled step; by "
        f"kernel {json.dumps(tr['top'])}")
    lines += [kernel_line(name, compare_backward(name, cases[name]),
                          tr["launches"][name]) for name in BACKWARD]

    # 9. the deformable-kernel benchmark
    lines += run_bench_phase()
    log(json.dumps({"kernels": lines}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
