"""The training step and loop (counterpart of
`mm_interleaved_tpu/engine/trainer.py`, one device).

* `Trainer.train_step` runs ``model(**batch)`` (the CE loss plus 10x the
  diffusion MSE, `MMInterleaved.forward`), its backward, and one `AdamW`
  update.  With ``grad_accum_steps > 1`` the batch carries a leading
  micro-batch axis; the micro-batches' gradients are summed in fp32 and
  averaged, as are their losses.
* The skip-nonfinite guard: a step whose loss or gradient norm is not
  finite leaves the parameters, the moments and the update count (hence the
  schedule) as they were; the step counter advances, as in the JAX trainer.
* Randomness: each micro-batch draws its diffusion noise, timesteps and
  uncond drops from a `torch.Generator` seeded by ``(seed, step, i)``, the
  counterpart of ``fold_in(PRNGKey(seed), step)``; ``draws`` injects them.
* Checkpoints (`torch.save`, ``step_{n}.pt`` under ``checkpoint_dir``) hold
  the trainable parameters (fp32 masters), the optimizer state, the step,
  the numpy global RNG state and the data position ``{"epoch",
  "offset"}``; `restore` resumes from the newest.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .optim import AdamW, OptimConfig, freeze


@dataclasses.dataclass
class TrainerConfig:
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    max_steps: int = 15000
    log_every: int = 10
    save_every: int = 1000
    keep_checkpoints: int = 5
    seed: int = 32
    skip_nonfinite_updates: bool = True
    checkpoint_dir: Optional[str] = None
    # micro-batches per optimizer step; the batch then has a leading
    # [grad_accum_steps, ...] axis
    grad_accum_steps: int = 1


METRIC_KEYS = ("loss_txt", "loss_img")


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, device):
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.labels = freeze(model, cfg.optim)
        named = [(n, p, self.labels[n]) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.optimizer = AdamW(named, cfg.optim)
        self.step = 0

    def generator(self, i: int = 0) -> torch.Generator:
        """The generator of micro-batch ``i`` of the current step."""
        seed = np.random.SeedSequence([self.cfg.seed, self.step, i])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed.generate_state(1)[0]))
        return g

    @staticmethod
    def _take_grad(p, master) -> torch.Tensor:
        """``p``'s gradient in fp32 (zeros where it got none), released
        from ``p`` so that bf16 and fp32 copies never coexist for all."""
        g = torch.zeros_like(master) if p.grad is None else p.grad.float()
        p.grad = None
        return g

    def _micro_batches(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        n = self.cfg.grad_accum_steps
        if n == 1:
            return [batch]
        return [{k: (v[i] if isinstance(v, torch.Tensor) else v)
                 for k, v in batch.items()} for i in range(n)]

    def train_step(self, batch: Dict[str, Any],
                   draws: Optional[List[Dict[str, torch.Tensor]]] = None
                   ) -> Dict[str, float]:
        """One optimizer step; returns the float metrics ``loss``,
        ``grad_norm``, ``loss_txt`` and ``loss_img``.  ``draws`` (one dict
        per micro-batch) injects ``vae_noise``, ``noise``, ``timesteps`` and
        ``uncond_drop``."""
        self.model.train()
        params = self.optimizer.params
        micro = self._micro_batches(batch)
        inv = 1.0 / len(micro)
        grads: Optional[List[torch.Tensor]] = None
        loss_sum = 0.0
        aux_sum: Dict[str, float] = {}
        for i, mb in enumerate(micro):
            for p in params:
                p.grad = None
            kw = draws[i] if draws is not None else {}
            out = self.model(**mb, generator=self.generator(i), **kw)
            out["loss"].backward()
            g = [self._take_grad(p, x)
                 for p, x in zip(params, self.optimizer.masters)]
            grads = g if grads is None else [a.add_(b)
                                             for a, b in zip(grads, g)]
            loss_sum += float(out["loss"].detach())
            for k in METRIC_KEYS:
                if k in out:
                    aux_sum[k] = aux_sum.get(k, 0.0) + float(out[k].detach())
        if len(micro) > 1:
            grads = [x.mul_(inv) for x in grads]
        loss = loss_sum * inv
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for x in grads:
            sq += x.pow(2).sum().to(sq.device)
        grad_norm = sq.sqrt()
        gnorm = float(grad_norm)
        ok = np.isfinite(loss) and np.isfinite(gnorm)
        if ok or not self.cfg.skip_nonfinite_updates:
            self.optimizer.step(grads, grad_norm)
        self.step += 1
        metrics = {"loss": loss, "grad_norm": gnorm}
        metrics.update({k: v * inv for k, v in aux_sum.items()})
        return metrics

    def fit(self, data_iter: Iterator[Dict[str, Any]],
            num_steps: Optional[int] = None,
            log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
            ) -> None:
        """Training loop over ``data_iter``, logging every ``log_every``
        steps and at the end, saving every ``save_every``."""
        num_steps = num_steps or self.cfg.max_steps
        n = self.cfg.grad_accum_steps
        t0 = time.time()
        for i in range(num_steps):
            if n == 1:
                batch = next(data_iter)
            else:
                micro = [next(data_iter) for _ in range(n)]
                batch = {k: (torch.stack([m[k] for m in micro])
                             if isinstance(micro[0][k], torch.Tensor)
                             else micro[0][k]) for k in micro[0]}
            metrics = self.train_step(batch)
            if log_fn and (self.step % self.cfg.log_every == 0
                           or i == num_steps - 1):
                metrics["steps_per_sec"] = (i + 1) / (time.time() - t0)
                log_fn(self.step, metrics)
            self.maybe_save(data_state=(data_iter.state()
                                        if hasattr(data_iter, "state")
                                        else None))

    # checkpoints

    def _payload(self, data_state: Optional[Dict] = None) -> dict:
        opt = self.optimizer
        return dict(
            params={n: x.detach().cpu()
                    for n, x in zip(opt.names, opt.masters)},
            opt_state={k: ({n: t.detach().cpu() for n, t in v.items()}
                           if isinstance(v, dict) else v)
                       for k, v in opt.state_dict().items()},
            step=self.step,
            host_rng=np.random.get_state(),
            data_state=dict(data_state or {"epoch": 0, "offset": 0}),
        )

    def _checkpoints(self) -> List[Path]:
        if not self.cfg.checkpoint_dir:
            return []
        d = Path(self.cfg.checkpoint_dir)
        found = [p for p in d.glob("step_*.pt") if p.stem[5:].isdigit()]
        return sorted(found, key=lambda p: int(p.stem[5:]))

    def maybe_save(self, data_state: Optional[Dict] = None,
                   force: bool = False) -> Optional[Path]:
        """Save at every ``save_every``-th step (or with ``force``), keeping
        the newest ``keep_checkpoints``; returns the file written."""
        if not self.cfg.checkpoint_dir:
            return None
        if not force and (self.cfg.save_every <= 0
                          or self.step % self.cfg.save_every):
            return None
        d = Path(self.cfg.checkpoint_dir)
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"step_{self.step}.pt"
        tmp = path.with_suffix(".tmp")
        torch.save(self._payload(data_state), tmp)
        os.replace(tmp, path)
        for old in self._checkpoints()[:-self.cfg.keep_checkpoints]:
            old.unlink()
        return path

    def restore(self, data_iter=None) -> bool:
        """Resume from the newest checkpoint: the trainable parameters, the
        optimizer state, the step, the numpy RNG and, when ``data_iter`` has
        ``restore``, the data position.  Returns whether one was found."""
        found = self._checkpoints()
        if not found:
            return False
        state = torch.load(found[-1], map_location=self.device,
                           weights_only=False)
        self.optimizer.load_state_dict(state["opt_state"], state["params"])
        self.step = int(state["step"])
        np.random.set_state(state["host_rng"])
        if data_iter is not None and hasattr(data_iter, "restore"):
            data_iter.restore(state["data_state"])
        return True
