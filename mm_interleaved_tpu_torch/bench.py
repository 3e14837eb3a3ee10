"""Benchmark of the PyTorch port: interleaved turns on one GPU (counterpart
of `bench.py`).

    python -m mm_interleaved_tpu_torch.bench [--device cuda|cpu]

Prints the card's ``nvidia-smi`` name and power limit, then ONE JSON line:
``{"metric": "interleaved_turns_per_sec_per_chip", "value": N, "unit":
..., "vs_baseline": N, ...}``.

One interleaved turn, as `bench.py` defines it: encode the image context,
prefill a 128-token prompt, decode 32 greedy tokens with no early stop
(`text_half`), then `generate_image_inputs` and one 25-step CFG denoise at
guidance 3.5 with the VAE decode (`image_half`), at B = 2 on the base
preset (`base_config(seq_len=512, max_num_images=2, remat=False)`, bf16,
seeded random weights).  The latency regime times ``BENCH_REPS`` turns
after a warm-up; the throughput regime times the text half alone at
``BENCH_THROUGHPUT_BATCH`` (8) rows.  The prompt and images come from
``RandomState(0)`` in `bench.py`'s order (`make_batch`).  Times are host
clocks around work that ends in `torch.cuda.synchronize()`.

``vs_baseline`` divides by `bench.py`'s component-wise A100-80GB estimate
of the reference pipeline at the same preset and workload.
``decode_hbm_util_est`` and ``decode_mfu_est`` read the throughput decode
against the H100's peaks (`utils.timing`): every decode step reads the
weights once.  The int8 decode fields wait for `ops/quant.py`.

Env (as `bench.py`): BENCH_PRESET=base|small|tiny (default base; tiny, on
the CPU with small step counts, is the tests' path), BENCH_BATCH,
BENCH_DECODE_TOKENS, BENCH_DENOISE_STEPS, BENCH_REPS,
BENCH_THROUGHPUT_BATCH.  Runs on the card; ``--device cpu`` runs on the
CPU.  Errors propagate: a failed run prints no line and exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .configs import base_config, small_config, tiny_config
from .generation.diffusion import generate_images
from .generation.text import TextGenerationConfig, generate_texts
from .models.mm_interleaved import build_model
from .utils.device import resolve_device, to_device
from .utils.timing import PEAK_BF16_FLOPS, PEAK_BYTES, card_line

PRESETS = {
    "base": lambda: base_config(seq_len=512, max_num_images=2, remat=False),
    "small": lambda: small_config(seq_len=256, max_num_images=2),
    "tiny": lambda: tiny_config(max_num_images=2),
}
PROMPT_LEN = 128
GUIDANCE = 3.5
NEVER_EOS = (999999,)  # no early stop: fixed work per turn


def a100_turns_per_sec_est(preset: str, B: int, n_decode: int,
                           n_denoise: int) -> float:
    """`bench.py`'s component-wise A100-80GB estimate of the reference stack
    (HF eager decode, diffusers UNet with CFG, MMFS overhead) at the same
    preset and workload: base ~30 tokens/s a row and 10.24 / B denoise
    steps/s; the smaller presets ~90 tokens/s a row and 96 / B."""
    if preset == "base":
        tok_per_sec = 30.0 * B
        denoise_steps_per_sec = 10.24 / B
    else:
        tok_per_sec = 90.0 * B
        denoise_steps_per_sec = 96.0 / B
    t_text = B * n_decode / tok_per_sec
    t_img = n_denoise / denoise_steps_per_sec
    return B / (t_text + t_img)


def prompt_row(cfg, rng: np.random.RandomState) -> np.ndarray:
    """`bench.py`'s prompt: ``<bos>``, 5, one image block, then random
    tokens in [10, 30000) (below the original vocabulary for the tiny
    preset), ``min(128, seq_len)`` tokens."""
    S = cfg.special
    L = min(PROMPT_LEN, cfg.seq_len)
    row = [S.bos_token_id, 5, S.soi_token_id] + \
        [S.image_token_id] * cfg.num_img_token
    hi = min(30000, cfg.orig_vocab_size)
    row += list(rng.randint(10, hi, size=L - len(row)))
    return np.asarray(row[:L], np.int32)


def make_batch(cfg, B: int, rng: np.random.RandomState,
               row: np.ndarray = None) -> Dict[str, np.ndarray]:
    """`B` copies of the prompt (``row``, else a new `prompt_row`), one
    image each in ``max_num_images`` slots and, for a new prompt, the
    decoder-size images `bench.py` draws for its init (drawn so that the
    draws after them stay `bench.py`'s)."""
    new = row is None
    if new:
        row = prompt_row(cfg, rng)
    ids = np.tile(row, (B, 1))
    enc = cfg.visual.encoder.vit.image_size
    batch = dict(
        text_ids=ids,
        image_tensors=rng.rand(B, cfg.max_num_images, enc, enc, 3)
        .astype(np.float32),
        num_image_per_seq=np.ones((B,), np.int32),
        attention_mask=np.ones_like(ids),
    )
    if new and cfg.image_decoder is not None:
        dec = cfg.image_decoder.image_size
        batch["image_tensors_dec"] = rng.rand(
            B, cfg.max_num_images, dec, dec, 3).astype(np.float32)
    return batch


def text_half(model, batch: Dict[str, torch.Tensor],
              n_decode: int) -> torch.Tensor:
    """Encode, prefill and ``n_decode`` greedy tokens with no early stop."""
    gen = TextGenerationConfig(max_new_tokens=n_decode,
                               eos_token_ids=NEVER_EOS,
                               pad_token_id=model.cfg.special.pad_token_id)
    return generate_texts(model, batch["text_ids"], batch["image_tensors"],
                          batch["num_image_per_seq"], batch["attention_mask"],
                          gen)


def image_half(model, batch: Dict[str, torch.Tensor], n_denoise: int,
               generator: torch.Generator) -> torch.Tensor:
    """`generate_image_inputs`, then the CFG denoise and VAE decode of the
    first B image slots (`bench.py`'s ``[:B]``)."""
    B = batch["text_ids"].shape[0]
    ctx, ctx_mask, values, mask = model.generate_image_inputs(
        batch["text_ids"], batch["image_tensors"],
        batch["num_image_per_seq"], batch["attention_mask"])
    return generate_images(model, ctx[:B], ctx_mask[:B], values[:B],
                           mask[:B], num_inference_steps=n_denoise,
                           guidance_scale=GUIDANCE, generator=generator)


def run(device: str = "cuda") -> Dict[str, Any]:
    """The benchmark's measurements (the JSON line's fields)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    preset = os.environ.get("BENCH_PRESET", "base")
    B = int(os.environ.get("BENCH_BATCH", "2" if preset == "base" else "8"))
    n_decode = int(os.environ.get("BENCH_DECODE_TOKENS", "32"))
    n_denoise = int(os.environ.get("BENCH_DENOISE_STEPS", "25"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    B8 = int(os.environ.get("BENCH_THROUGHPUT_BATCH", "8"))

    cfg = PRESETS[preset]()
    rng = np.random.RandomState(0)
    batch = make_batch(cfg, B, rng)
    row = batch["text_ids"][0]
    batch = to_device({k: v for k, v in batch.items()
                       if k != "image_tensors_dec"}, device)
    model = build_model(cfg, device, seed=0)

    def generator(i):
        g = torch.Generator(device=device)
        g.manual_seed(i)
        return g

    with torch.inference_mode():
        # warm-up
        text_half(model, batch, n_decode)
        image_half(model, batch, n_denoise, generator(0))
        sync()

        # latency regime (B rows, default 2): per-half timings
        t_text = t_img = 0.0
        for i in range(reps):
            t0 = time.perf_counter()
            text_half(model, batch, n_decode)
            sync()
            t1 = time.perf_counter()
            image_half(model, batch, n_denoise, generator(i))
            sync()
            t_text += t1 - t0
            t_img += time.perf_counter() - t1

        # throughput regime: the text half at B8 rows
        b8 = to_device(make_batch(cfg, B8, rng, row=row), device)
        text_half(model, b8, n_decode)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            text_half(model, b8, n_decode)
            sync()
        t_text8 = time.perf_counter() - t0

    turns_per_sec = reps * B / (t_text + t_img)
    step_s8 = t_text8 / (reps * n_decode)
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    baseline = a100_turns_per_sec_est(preset, B, n_decode, n_denoise)
    return {
        "metric": "interleaved_turns_per_sec_per_chip",
        "value": turns_per_sec,
        "unit": f"turns/s/chip (preset={preset}, B={B}, "
                f"{n_decode} tok + {n_denoise} denoise steps)",
        "vs_baseline": turns_per_sec / baseline,
        "baseline_est_turns_per_sec": baseline,
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        # latency regime
        "decode_ms_per_tok_latency": 1e3 * t_text / (reps * n_decode),
        "denoise_steps_per_sec": reps * n_denoise / t_img,
        # throughput regime (text decode at B8 rows)
        "throughput_batch": B8,
        "decode_ms_per_tok_throughput": 1e3 * step_s8,
        "tokens_per_sec_throughput": B8 / step_s8,
        # the throughput decode against the H100's peaks
        "decode_hbm_util_est": param_bytes / step_s8 / PEAK_BYTES,
        "decode_mfu_est": 2.0 * n_params * B8 / step_s8 / PEAK_BF16_FLOPS,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    if torch.device(args.device).type == "cuda":
        print(card_line(), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
