"""One rank of the sharded-training tests (tests/test_torch_sharded_train*.py
and tests/test_torch_train.py), run under `_torch_dist.run_ranks`:

    python tests/_torch_train_worker.py JOB.pt OUT.pt

``JOB.pt`` (written by the test) holds the mesh, the port's state dict of
the tiny preset, the config's changes, the optimizer's settings and a list
of cases, each with its global batch (and injected draws, where given).
The rank builds the model on the CPU for each case, trains it with
`Trainer` on the mesh (gloo) and rank 0 saves each case's results to
``OUT.pt``: the metrics and the gathered checkpoint payload (every
trainable master and both moments, global).  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import torch
import torch.distributed as dist

import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.engine.optim import OptimConfig, local_part
from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.parallel.partition import make_mesh


def tiny_config(dropout: float = 0.0):
    """The tiny preset with its image decoder, fp32, ``scan_layers=False``
    (the JAX tests' layout); ``dropout`` in both resamplers."""
    cfg = tcfg.tiny_config(with_image_decoder=True, scan_layers=False)
    vis, dec = cfg.visual, cfg.image_decoder
    return dataclasses.replace(
        cfg,
        visual=dataclasses.replace(vis, perceiver=dataclasses.replace(
            vis.perceiver, dropout=dropout)),
        image_decoder=dataclasses.replace(
            dec, vae_decode_dtype="float32",
            perceiver=dataclasses.replace(dec.perceiver, dropout=dropout)))


def tiny_model(state, dropout: float = 0.0, optim: dict = None):
    model = build_model(tiny_config(dropout), "cpu", torch.float32,
                        optim=OptimConfig(**optim))
    with torch.no_grad():
        model.load_state_dict(state, strict=True)
    return model


class Position:
    """A data iterator's position, as `Trainer.restore` sets it."""

    def __init__(self):
        self.restored = None

    def restore(self, state):
        self.restored = dict(state)


def global_weights(tr: Trainer) -> dict:
    """Every parameter of the sharded model, gathered (global)."""
    return {n: tr._global(n, local_part(p))
            for n, p in tr.model.named_parameters()}


def trainer(job, case, mesh, ckpt=None, **cfg):
    model = tiny_model(job["state"], case.get("dropout", 0.0), job["optim"])
    return Trainer(model, TrainerConfig(
        optim=OptimConfig(**job["optim"]), checkpoint_dir=ckpt, **cfg),
        "cpu", mesh=mesh)


def run_case(job, case, mesh, scratch):
    kind = case["kind"]
    batch, draws = case["batch"], case.get("draws")
    out = {}
    if kind in ("step", "guard"):
        tr = trainer(job, case, mesh,
                     grad_accum_steps=case.get("accum", 1))
        if case.get("grads"):
            # this rank's gradients before any sum over the ranks (after
            # it with grads="summed")
            seen = {}
            total = tr._sum_grads

            def spy(grads):
                if case["grads"] == "summed":
                    total(grads)
                seen.update(zip(tr.optimizer.names,
                                [g.clone() for g in grads]))
                if case["grads"] != "summed":
                    total(grads)

            tr._sum_grads = spy
        out["metrics"] = tr.train_step(batch, draws)
        out["count"], out["step"] = tr.optimizer.count, tr.step
        out["payload"] = tr._payload()
        out["weights"] = global_weights(tr)
        if case.get("grads"):
            out["grads"] = seen
    elif kind == "resume":
        # two steps with a checkpoint after each; then a fresh model
        # resumes from the first and takes the second
        d1, d2 = (os.path.join(scratch, x) for x in ("c1", "c2"))
        tr = trainer(job, case, mesh, ckpt=d1,
                     grad_accum_steps=case.get("accum", 1))
        out["metrics"] = [tr.train_step(batch[0], draws and draws[0])]
        tr.maybe_save(data_state={"epoch": 0, "offset": 1}, force=True)
        tr.cfg.checkpoint_dir = d2
        out["metrics"].append(tr.train_step(batch[1], draws and draws[1]))
        out["payload"] = tr._payload()
        again = trainer(job, case, mesh, ckpt=d1,
                        grad_accum_steps=case.get("accum", 1))
        pos = Position()
        assert again.restore(pos)
        out["restored_step"], out["position"] = again.step, pos.restored
        out["resumed_metrics"] = again.train_step(batch[1],
                                                  draws and draws[1])
        out["resumed_payload"] = again._payload()
        out["checkpoint"] = os.path.join(d1, "step_1.pt")
        if again.writer and case.get("keep"):
            keep = case["keep"]
            os.makedirs(os.path.dirname(keep), exist_ok=True)
            shutil.copy(out["checkpoint"], keep)
    elif kind == "warm":
        # a warm start from a full checkpoint, then one step
        tr = trainer(job, case, mesh)
        tr.warm_start(case["from"])
        out["start"] = tr._payload()
        out["metrics"] = tr.train_step(batch, draws)
        out["payload"] = tr._payload()
        out["weights"] = global_weights(tr)
    elif kind == "restore":
        # resume from a checkpoint another run wrote, then one step
        tr = trainer(job, case, mesh, ckpt=case["from"],
                     grad_accum_steps=case.get("accum", 1))
        pos = Position()
        assert tr.restore(pos)
        out["restored"] = tr._payload()
        out["restored_step"], out["position"] = tr.step, pos.restored
        out["metrics"] = tr.train_step(batch, draws)
        out["payload"] = tr._payload()
    else:
        raise ValueError(kind)
    return out


def main(job_path: str, out_path: str) -> int:
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo")
    torch.manual_seed(0)
    mesh = make_mesh(*job["mesh"], "cpu")
    r = dist.get_rank()
    scratch = f"{out_path}.scratch"
    results = {}
    for name, case in job["cases"].items():
        results[name] = run_case(job, case, mesh,
                                 os.path.join(scratch, name))
        dist.barrier()
    if r == 0:
        torch.save(results, out_path)
    if job.get("every_rank"):
        torch.save({k: {x: v[x] for x in job["every_rank"] if x in v}
                    for k, v in results.items()}, f"{out_path}.rank{r}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
