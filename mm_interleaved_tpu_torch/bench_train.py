"""Training-step throughput of the PyTorch port on one GPU (counterpart of
`bench_train.py`).

    python -m mm_interleaved_tpu_torch.bench_train [--device cuda|cpu]

Prints the card's ``nvidia-smi`` name and power limit, then ONE JSON line
(``"metric": "train_step_throughput"``) with:

* **small preset**: the full `Trainer.train_step` (the CE + 10x diffusion
  loss, its backward, the AdamW update, the skip-nonfinite guard) at B = 8
  rows of 512 tokens, 2 image slots a row, remat on: steps/s, tokens/s,
  MFU estimate.
* **base preset**: the full `Trainer.train_step` at B = 1 row of 2,048
  tokens (``base_full_*``): it fits on one 80 GB card, since the optimizer
  keeps fp32 masters and moments for the trainable leaves only; and the
  forward and backward alone (``base_fwdbwd_*``:
  `Trainer.forward_backward`, the gradients of the trainable leaves as the
  step computes them).  A step that does not fit
  raises.

The batches follow `bench_train.py`'s recipe (`train_batch`,
``RandomState(0)``).  Times are host clocks around ``BENCH_TRAIN_REPS``
steps after a warm step, each ending in `torch.cuda.synchronize()`.  The
MFU estimates count 6 x parameters x tokens against the H100's bf16 peak
(`utils.timing`).  ``vs_baseline`` is `bench_train.py`'s: the small step
against an A100 at 30% of 140 TFLOP/s doing the same 6ND.

Env (as `bench_train.py`): BENCH_TRAIN_REPS (default 5),
BENCH_TRAIN_SECTION=all|small|base, BENCH_TRAIN_BATCH,
BENCH_TRAIN_BASE_BATCH.  Runs on the card; ``--device cpu`` runs on the
CPU.  Errors propagate: a failed run prints no line and exits
nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from .configs import base_config, small_config
from .engine.optim import OptimConfig
from .engine.trainer import Trainer, TrainerConfig
from .models.mm_interleaved import build_model
from .utils.device import resolve_device, to_device
from .utils.timing import PEAK_BF16_FLOPS, card_line


OPTIM = OptimConfig(warmup_steps=10, total_steps=1000)


def train_batch(cfg, B: int, L: int,
                rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """`bench_train.py`'s batch: B copies of ``<bos>``, 5, one image block
    and random tokens (below the original vocabulary for the tiny preset),
    the images and the decoder's targets uniform in [0, 1]."""
    S = cfg.special
    row = [S.bos_token_id, 5, S.soi_token_id] + \
        [S.image_token_id] * cfg.num_img_token
    row += list(rng.randint(10, min(30000, cfg.orig_vocab_size),
                            size=L - len(row)))
    ids = np.tile(np.asarray(row[:L], np.int32), (B, 1))
    enc = cfg.visual.encoder.vit.image_size
    dec = cfg.image_decoder.image_size
    return dict(
        text_ids=ids,
        image_tensors=rng.rand(B, cfg.max_num_images, enc, enc, 3)
        .astype(np.float32),
        num_image_per_seq=np.ones((B,), np.int32),
        attention_mask=np.ones((B, L), np.int32),
        image_tensors_dec=rng.rand(B, cfg.max_num_images, dec, dec, 3)
        .astype(np.float32),
    )


def _setup(cfg, B: int, L: int, device):
    model = build_model(cfg, device, seed=0, optim=OPTIM)
    trainer = Trainer(model, TrainerConfig(optim=OPTIM, checkpoint_dir=None),
                      device)
    batch = to_device(train_batch(cfg, B, L, np.random.RandomState(0)),
                      device)
    n_params = sum(p.numel() for p in model.parameters())
    return trainer, batch, n_params


def _mean_s(fn, reps: int, device) -> float:
    """Mean seconds of ``fn`` over ``reps`` runs after a warm one."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    return (time.perf_counter() - t0) / reps


def run_small(reps: int, device) -> Dict[str, Any]:
    B = int(os.environ.get("BENCH_TRAIN_BATCH", "8"))
    cfg = small_config(seq_len=512, max_num_images=2, remat=True)
    L = cfg.seq_len
    trainer, batch, n_params = _setup(cfg, B, L, device)
    dt = _mean_s(lambda: trainer.train_step(batch), reps, device)
    tokens = B * L
    return {
        "small_steps_per_sec": 1.0 / dt,
        "small_tokens_per_sec": tokens / dt,
        "small_step_ms": dt * 1e3,
        "small_batch": B,
        "small_seq_len": L,
        "small_n_params": n_params,
        "small_train_mfu_est": 6.0 * n_params * tokens / dt / PEAK_BF16_FLOPS,
    }


def run_base(reps: int, device) -> Dict[str, Any]:
    B = int(os.environ.get("BENCH_TRAIN_BASE_BATCH", "1"))
    cfg = base_config(seq_len=2048, max_num_images=2, remat=True)
    L = cfg.seq_len
    trainer, batch, n_params = _setup(cfg, B, L, device)
    full = _mean_s(lambda: trainer.train_step(batch), reps, device)
    dt = _mean_s(lambda: trainer.forward_backward(batch), reps, device)
    tokens = B * L
    flops = 6.0 * n_params * tokens
    return {
        "base_fwdbwd_steps_per_sec": 1.0 / dt,
        "base_fwdbwd_tokens_per_sec": tokens / dt,
        "base_fwdbwd_step_ms": dt * 1e3,
        "base_batch": B,
        "base_seq_len": L,
        "base_n_params": n_params,
        "base_fwdbwd_mfu_est": flops / dt / PEAK_BF16_FLOPS,
        "base_full_steps_per_sec": 1.0 / full,
        "base_full_step_ms": full * 1e3,
        "base_full_mfu_est": flops / full / PEAK_BF16_FLOPS,
    }


def run(device: str = "cuda") -> Dict[str, Any]:
    """The benchmark's measurements (the JSON line's fields)."""
    device = resolve_device(device)
    reps = int(os.environ.get("BENCH_TRAIN_REPS", "5"))
    section = os.environ.get("BENCH_TRAIN_SECTION", "all")
    out = {"metric": "train_step_throughput", "unit": "see fields",
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    if section in ("all", "small"):
        out.update(run_small(reps, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # headline: the small step against a 30%-MFU A100 (140 TFLOP/s)
        # doing the same 6ND
        a100_step_s = (6.0 * out["small_n_params"] * out["small_batch"]
                       * out["small_seq_len"] / (0.30 * 140e12))
        out["value"] = out["small_steps_per_sec"]
        out["vs_baseline"] = a100_step_s / (out["small_step_ms"] / 1e3)
    if section in ("all", "base"):
        out.update(run_base(reps, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


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
