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

Runs on the card; ``--device cpu`` runs on the CPU.  A ``mesh:`` stanza
over more than one device trains sharded (`engine.trainer.Trainer` on the
``(data, fsdp, tensor)`` mesh; ``data: -1``, the default, is the rest of
the world), one process a device under torchrun::

    torchrun --nproc_per_node N -m mm_interleaved_tpu_torch.train \
        --config configs/pretrain.yaml [--device cpu]

With ``distributed.initialize`` or a ``WORLD_SIZE`` above 1 the process
group comes from torchrun's environment (nccl on the card, gloo with
``--device cpu``); a mesh over more than one device without one raises.
Every rank builds the same global batch of ``per_device_batch_size`` rows
(as JAX's processes do) and the Trainer takes its rows; rank 0 prints the
lines, dumps the config and writes the checkpoints, which hold global
tensors: a run resumes on any mesh.  Errors propagate: a failed run exits
nonzero.
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
from .utils.logging import rank


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


def training_mesh(cfg: Dict[str, Any], device):
    """This rank's device and mesh: the process group from torchrun's
    environment under ``distributed.initialize`` or a ``WORLD_SIZE`` above
    1, then the ``mesh:`` stanza's `DeviceMesh` (None for one device).  A
    mesh over more than one device with no process group raises
    `RuntimeError`."""
    from .parallel.inference import init_distributed, runtime_mesh_shape
    from .parallel.partition import make_mesh

    initialize = bool((cfg.get("distributed", {}) or {}).get("initialize"))
    device = init_distributed(str(device), initialize)
    shape = runtime_mesh_shape(cfg.get("mesh"), default_data=-1)
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return device, None
    return device, make_mesh(*shape, device.type)


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
    load_from = args.load_from or tr.get("load_from")
    device, mesh = training_mesh(cfg, resolve_device(args.device))
    writer = rank() == 0
    output_dir = args.output_dir or cfg.get("output_dir", "OUTPUT/run")
    os.makedirs(output_dir, exist_ok=True)
    if writer:
        dump_config(cfg, output_dir)

    model_cfg = build_model_config(cfg["model"])
    optim = optim_config(tr, args.max_steps)
    seed = tr.get("seed", 32)
    model = build_model(model_cfg, device, seed=seed, optim=optim)
    if writer:
        print_parameter_counts(model)
    trainer = Trainer(model, TrainerConfig(
        optim=optim,
        max_steps=optim.total_steps,
        log_every=tr.get("logging_steps", 10),
        save_every=tr.get("save_steps", 1000),
        keep_checkpoints=tr.get("save_total_limit", 5),
        seed=seed,
        checkpoint_dir=os.path.join(output_dir, "checkpoints"),
    ), device, mesh=mesh)

    data_iter, _ = build_train_iterator(cfg.get("data", {}) or {}, model_cfg)
    say = print if writer else (lambda *a, **k: None)
    if trainer.restore(data_iter):
        say(f"resumed at step {trainer.step}, data position "
            f"{data_iter.state()}", flush=True)
    elif load_from:
        trainer.warm_start(load_from)
        say(f"warm-started params from {load_from}", flush=True)
    batches = prefetch(data_iter, size=2)
    logged = []

    def log_fn(step, metrics):
        say(f"step {step}: " + " ".join(
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
    say(f"saved {path} ({size / 1e9:.3f} GB) in {save_s:.1f} s", flush=True)
    return dict(logged=logged, trainer=trainer, checkpoint=path,
                checkpoint_bytes=size, save_s=save_s)


if __name__ == "__main__":
    main()
