"""Training entry point of the PyTorch port (counterpart of `train.py`).

    python -m mm_interleaved_tpu_torch.train --config configs/pretrain_synthetic.yaml \
        [--output_dir OUT] [--max_steps N] [--device cuda|cpu]

As `train.py` does: load the YAML and dump it to the output dir, build the
optimizer config from ``training:``, the model in its training form
(seeded weights, ``training.seed``), the `Trainer`, and
`data.pipeline.build_train_iterator`; resume from the newest checkpoint of
``<output_dir>/checkpoints`` (the trainable masters, the optimizer, the step
and the data position; the frozen weights are rebuilt from the same seed,
or read again from the full checkpoint of the warm start below);
train the remaining steps, printing ``step N: loss=... grad_norm=...``
lines; save a final checkpoint.  With ``--load_from`` (or
``training.load_from``), a full checkpoint of the port (``python -m
mm_interleaved_tpu_torch.convert_checkpoint``: the released model, or the
towers assembled for a pretrain), the run starts from its weights, as
`train.py:101-117` does: only when no checkpoint of the run exists (step
0; a resume wins), every weight from the file, the fp32 masters from the
same values, the optimizer's moments fresh.

Batches stay numpy in the data layer.  `data.pipeline.prefetch` makes them
two ahead in a background thread and reports as its position the one after
the last batch taken, so a checkpoint resumes at exactly the next unconsumed
batch (the prefetching thread's own iterator runs ahead of it; the JAX
`train.py` skips ``step`` batches instead, which is the position only at
one batch a step); `Trainer.fit` moves each batch to the device as it
takes it.

Runs on the card; ``--device cpu`` runs on the CPU.  It refuses what the
port cannot do yet rather than ignore it: a mesh of more than one device
and ``distributed.initialize`` (the sharded Trainer, ROADMAP.md §1 item 6b).
Errors propagate: a failed run exits nonzero.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, Optional

from .data.pipeline import build_train_iterator, prefetch
from .engine.optim import OptimConfig
from .engine.trainer import Trainer, TrainerConfig
from .models.mm_interleaved import build_model
from .utils.config import build_model_config, dump_config, load_config
from .utils.device import resolve_device


def optim_config(tr: Dict[str, Any], max_steps: Optional[int]) -> OptimConfig:
    """`train.py`'s optimizer config from the ``training:`` section."""
    return OptimConfig(
        learning_rate=tr.get("learning_rate", 1e-4),
        weight_decay=tr.get("weight_decay", 0.05),
        beta1=tr.get("adam_beta1", 0.9),
        beta2=tr.get("adam_beta2", 0.995),
        eps=tr.get("adam_epsilon", 1e-6),
        warmup_steps=tr.get("warmup_steps", 1000),
        total_steps=max_steps or tr.get("max_steps", 15000),
        grad_clip=tr.get("max_grad_norm", 1.0),
    )


def check_supported(cfg: Dict[str, Any]) -> None:
    """Refuse the settings the port does not implement yet."""
    mesh = cfg.get("mesh", {}) or {}
    axes = {k: mesh.get(k, d) for k, d in (("data", -1), ("fsdp", 1),
                                            ("tensor", 1))}
    if axes["fsdp"] > 1 or axes["tensor"] > 1 or axes["data"] > 1:
        raise NotImplementedError(
            f"mesh {axes} asks for more than one device; the port trains on "
            "one (the sharded Trainer is ROADMAP.md §1 item 6b; serving "
            "runs sharded)")
    if (cfg.get("distributed", {}) or {}).get("initialize", False):
        raise NotImplementedError(
            "distributed.initialize: the port trains in one process (the "
            "sharded Trainer is ROADMAP.md §1 item 6b)")


def print_parameter_counts(model) -> None:
    """Trainable and frozen parameters, in all and per top-level module."""
    rows: Dict[str, list] = {}
    for name, p in model.named_parameters():
        row = rows.setdefault(name.split(".", 1)[0], [0, 0])
        row[0 if p.requires_grad else 1] += p.numel()
    train = sum(r[0] for r in rows.values())
    frozen = sum(r[1] for r in rows.values())
    print(f"MMInterleaved: {train + frozen:,} parameters, {train:,} "
          f"trainable (fp32 masters), {frozen:,} frozen", flush=True)
    for mod, (t, f) in rows.items():
        print(f"  {mod}: {t:,} trainable, {f:,} frozen", flush=True)


def main(argv=None) -> Dict[str, Any]:
    """Run the training entry point; returns the logged metrics
    (``logged``: ``(step, metrics)``), the `Trainer`, the final checkpoint's
    path, size and write time."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--load_from", default=None,
                    help="a full checkpoint to start from at step 0")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    tr = cfg.get("training", {}) or {}
    check_supported(cfg)
    load_from = args.load_from or tr.get("load_from")
    device = resolve_device(args.device)
    output_dir = args.output_dir or cfg.get("output_dir", "OUTPUT/run")
    os.makedirs(output_dir, exist_ok=True)
    dump_config(cfg, output_dir)

    model_cfg = build_model_config(cfg["model"])
    optim = optim_config(tr, args.max_steps)
    seed = tr.get("seed", 32)
    model = build_model(model_cfg, device, seed=seed, optim=optim)
    print_parameter_counts(model)
    trainer = Trainer(model, TrainerConfig(
        optim=optim,
        max_steps=optim.total_steps,
        log_every=tr.get("logging_steps", 10),
        save_every=tr.get("save_steps", 1000),
        keep_checkpoints=tr.get("save_total_limit", 5),
        seed=seed,
        checkpoint_dir=os.path.join(output_dir, "checkpoints"),
    ), device)

    data_iter, _ = build_train_iterator(cfg.get("data", {}) or {}, model_cfg)
    if trainer.restore(data_iter):
        print(f"resumed at step {trainer.step}, data position "
              f"{data_iter.state()}", flush=True)
    elif load_from:
        trainer.warm_start(load_from)
        print(f"warm-started params from {load_from}", flush=True)
    batches = prefetch(data_iter, size=2)
    logged = []

    def log_fn(step, metrics):
        print(f"step {step}: " + " ".join(
            f"{k}={v:.4g}" for k, v in metrics.items()), flush=True)
        logged.append((step, dict(metrics)))

    try:
        remaining = optim.total_steps - trainer.step
        if remaining > 0:
            trainer.fit(batches, num_steps=remaining, log_fn=log_fn)
        t0 = time.perf_counter()
        path = trainer.maybe_save(data_state=batches.state(), force=True)
        save_s = time.perf_counter() - t0
    finally:
        batches.close()
    size = path.stat().st_size
    print(f"saved {path} ({size / 1e9:.3f} GB) in {save_s:.1f} s",
          flush=True)
    return dict(logged=logged, trainer=trainer, checkpoint=path,
                checkpoint_bytes=size, save_s=save_s)


if __name__ == "__main__":
    main()
