"""The training step and loop (counterpart of
`mm_interleaved_tpu/engine/trainer.py`), on one device or on one rank of a
``(data, fsdp, tensor)`` mesh.

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
* Reproducibility: a step's forward and backward (`forward_backward`) run
  with cuDNN's deterministic algorithms, so one state and one batch give
  the same bits every run and a resumed run repeats the uninterrupted one
  (the default algorithms of some convolution weight gradients, the tiny
  preset's fp32 UNet's, sum in a varying order); the setting is restored
  after them.
* Checkpoints (`torch.save`, ``step_{n}.pt`` under ``checkpoint_dir``) hold
  the trainable parameters (fp32 masters), the optimizer state, the step,
  the seed (that of the frozen weights, in the entry point), the record of
  the full checkpoint the run was warm-started from (``load_from``: its
  path, size and id; None for a seeded start), the numpy global RNG state
  and the data position ``{"epoch", "offset"}``; `restore` resumes from
  the newest, every weight first from the recorded full checkpoint when
  there is one.

On a mesh (``mesh``, `parallel.partition.make_mesh`; JAX's GSPMD step, whose
arithmetic is the one-device step's):

* the whole model on the rank's device is cut over ``tensor``
  (`parallel.tensor.shard_tensor_parallel`, with Megatron's f and g in the
  backward) and sharded over ``fsdp`` (`parallel.partition.shard_fsdp`, the
  gradients reduce-scattered as fp32 sums); the fp32 masters and both
  moments are the rank's shards;
* every rank receives the global batch and runs its rows
  (`parallel.partition.batch_rows`, of each micro-batch), replicated where
  ``data * fsdp`` does not divide it; every random draw is made at the
  global batch and sliced (`utils.draws.RowDraws`), injected draws too;
* both losses are normalised by global counts (the valid labels, the image
  slots), so a rank's gradient is its share of the global loss's; the
  gradients that FSDP2 does not reduce are summed over ``(fsdp, data)``, the
  sharded ones over ``data``, in fp32, in a fixed order;
* the reported loss and the gradient norm are global, from one all-gather
  of each rank's shares and sums of squares (each leaf counted once), the
  step's one host sync; so the clip and the guard agree on every rank;
* checkpoints are gathered: rank 0 writes the one-process layout, and
  `restore` and `warm_start` take each rank's slice of the global tensors,
  so a run resumes on any mesh.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.checkpoint import (full_checkpoint_record, read_full_checkpoint,
                                read_recorded_full)
from ..utils.device import to_device
from ..utils.draws import RowDraws
from .optim import AdamW, OptimConfig, freeze, local_part


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
# the elements of one all-reduce of the gradients (fp32: 256 MB)
BUCKET = 1 << 26


class Trainer:
    def __init__(self, model, cfg: TrainerConfig, device, mesh=None):
        """``model`` whole on ``device``; with ``mesh`` it is cut and
        sharded in place to this rank's part first."""
        self.model = model
        self.cfg = cfg
        self.device = torch.device(device)
        self.labels = freeze(model, cfg.optim)
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            from ..parallel.partition import RankLayout, shard_fsdp
            from ..parallel.tensor import shard_tensor_parallel

            cuts = shard_tensor_parallel(model, mesh)
            shard_fsdp(model, mesh, train=True)
            self.layout = RankLayout(model, mesh, cuts)
        named = [(n, p, self.labels[n]) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.optimizer = AdamW(named, cfg.optim)
        self.step = 0
        # the full checkpoint of `warm_start` (`full_checkpoint_record`)
        self.load_from: Optional[Dict[str, Any]] = None

    @property
    def writer(self) -> bool:
        """Whether this process writes checkpoints (rank 0 of a mesh)."""
        import torch.distributed as dist

        return self.mesh is None or dist.get_rank() == 0

    def _row_ranks(self) -> int:
        """The ranks that split a batch's rows (``data * fsdp``)."""
        if self.layout is None:
            return 1
        return self.layout.sizes["data"] * self.layout.sizes["fsdp"]

    def generator(self, i: int = 0) -> torch.Generator:
        """The generator of micro-batch ``i`` of the current step."""
        seed = np.random.SeedSequence([self.cfg.seed, self.step, i])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed.generate_state(1)[0]))
        return g

    @staticmethod
    def _take_grad(p, master) -> torch.Tensor:
        """``p``'s gradient on this rank in fp32 (zeros where it got none),
        released from ``p`` so that bf16 and fp32 copies never coexist for
        all."""
        g = p.grad
        if g is None:
            g = torch.zeros_like(master)
        else:
            g = (g.to_local() if hasattr(g, "to_local") else g).float()
        p.grad = None
        return g

    def _micro_batches(self, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
        n = self.cfg.grad_accum_steps
        if n == 1:
            return [batch]
        return [{k: (v[i] if isinstance(v, torch.Tensor) else v)
                 for k, v in batch.items()} for i in range(n)]

    def _rows(self, mb: Dict[str, Any], kw: Dict[str, torch.Tensor], g):
        """This rank's rows of micro-batch ``mb`` (global on every rank),
        its rows' slots of the injected draws ``kw``, the generator wrapped
        to draw at the global batch, and the count reduction of the
        global loss normalisers (None off a mesh)."""
        if self._row_ranks() == 1:
            return mb, kw, g, None
        from ..parallel.partition import batch_rows, row_sum

        B = mb["text_ids"].shape[0]
        rows = batch_rows(self.mesh, B)

        def take(v):
            k = v.shape[0] // B
            return v[rows.start * k:rows.stop * k]

        mb = {k: (take(v) if isinstance(v, torch.Tensor) and v.dim()
                  and v.shape[0] % B == 0 else v) for k, v in mb.items()}
        kw = {k: take(v) for k, v in kw.items()}
        return (mb, kw, RowDraws(g, rows, B),
                lambda c: row_sum(c.clone(), self.mesh))

    def forward_backward(self, batch: Dict[str, Any],
                         draws: Optional[List[Dict[str, torch.Tensor]]] = None
                         ) -> Tuple[List[torch.Tensor], torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """The forward and backward of every micro-batch of ``batch``, with
        cuDNN's deterministic algorithms (restored after): the fp32
        gradients of this rank's trainable leaves, averaged over the
        micro-batches, the mean loss and the mean ``loss_txt`` /
        ``loss_img`` (0-d tensors; on a mesh, this rank's shares of the
        global ones, and its gradients not yet summed over the ranks)."""
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._forward_backward(batch, draws)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _forward_backward(self, batch, draws):
        self.model.train()
        params = self.optimizer.params
        micro = self._micro_batches(batch)
        inv = 1.0 / len(micro)
        grads: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        aux_sum: Dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            for p in params:
                p.grad = None
            mb, kw, g, count_reduce = self._rows(
                mb, draws[i] if draws is not None else {}, self.generator(i))
            out = self.model(**mb, generator=g, count_reduce=count_reduce,
                             **kw)
            out["loss"].backward()
            grads_i = [self._take_grad(p, x)
                       for p, x in zip(params, self.optimizer.masters)]
            grads = grads_i if grads is None else [
                a.add_(b) for a, b in zip(grads, grads_i)]
            loss_sum += out["loss"].detach().float()
            for k in METRIC_KEYS:
                if k in out:
                    v = out[k].detach().float()
                    aux_sum[k] = aux_sum[k] + v if k in aux_sum else v
        if len(micro) > 1:
            grads = [x.mul_(inv) for x in grads]
            loss_sum = loss_sum * inv
            aux_sum = {k: v * inv for k, v in aux_sum.items()}
        return grads, loss_sum, aux_sum

    def _sum_grads(self, grads: List[torch.Tensor]) -> None:
        """Sum this rank's fp32 gradients in place over the ranks that hold
        rows: FSDP2's shards over ``data``, every other leaf over ``fsdp``,
        then ``data``; in buckets of at most ``BUCKET`` elements, in
        parameter order."""
        import torch.distributed as dist

        sizes = self.layout.sizes
        groups = {("data",): [], ("fsdp", "data"): []}
        for n, g in zip(self.optimizer.names, grads):
            sharded = n in self.layout.fsdp
            groups[("data",) if sharded else ("fsdp", "data")].append(g)
        for axes, gs in groups.items():
            axes = [a for a in axes if sizes[a] > 1]
            i = 0
            while axes and i < len(gs):
                j, n = i, 0
                while j < len(gs) and (j == i or n + gs[j].numel() <= BUCKET):
                    n += gs[j].numel()
                    j += 1
                flat = torch.cat([g.reshape(-1) for g in gs[i:j]])
                for a in axes:
                    dist.all_reduce(flat, group=self.mesh.get_group(a))
                off = 0
                for g in gs[i:j]:
                    g.copy_(flat[off:off + g.numel()].view_as(g))
                    off += g.numel()
                i = j

    def _global_stats(self, loss: torch.Tensor, aux: Dict[str, torch.Tensor],
                      grads: List[torch.Tensor]) -> torch.Tensor:
        """``[loss, loss_txt, loss_img, grad_norm]`` of the step (0 where
        a loss is absent): on a mesh, the losses summed over the ranks that
        hold rows and the norm over every leaf's shards, each leaf counted
        once, from one all-gather of every rank's shares and sums of
        squares, combined in one fixed order on every rank."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        # sums of squares by the axes a leaf is split over: none, fsdp,
        # tensor, both
        sq = [zero.clone() for _ in range(4)]
        for n, x in zip(self.optimizer.names, grads):
            axes = () if self.layout is None else self.layout.split_axes(n)
            j = ("fsdp" in axes) + 2 * ("tensor" in axes)
            sq[j] += x.pow(2).sum().to(self.device)
        mine = torch.stack([loss] + [aux.get(k, zero) for k in METRIC_KEYS]
                           + sq)
        if self.mesh is None:
            table = mine[None]
            D = F = T = 1
        else:
            import torch.distributed as dist

            D, F, T = (self.layout.sizes[a] for a in ("data", "fsdp",
                                                        "tensor"))
            parts = [torch.empty_like(mine) for _ in range(D * F * T)]
            dist.all_gather(parts, mine)
            table = torch.stack(parts)

        def total(col, ds, fs, ts):
            out = zero
            for d in ds:
                for f in fs:
                    for t in ts:
                        out = out + table[(d * F + f) * T + t, col]
            return out

        rows = (range(D), range(F), (0,))
        losses = [total(c, *rows) for c in range(3)]
        norm2 = (total(3, (0,), (0,), (0,)) + total(4, (0,), range(F), (0,))
                 + total(5, (0,), (0,), range(T))
                 + total(6, (0,), range(F), range(T)))
        return torch.stack(losses + [norm2.sqrt()])

    def train_step(self, batch: Dict[str, Any],
                   draws: Optional[List[Dict[str, torch.Tensor]]] = None
                   ) -> Dict[str, float]:
        """One optimizer step; returns the float metrics ``loss``,
        ``grad_norm``, ``loss_txt`` and ``loss_img`` (global on a mesh).
        ``draws`` (one dict per micro-batch, at the global batch) injects
        ``vae_noise``, ``noise``, ``timesteps`` and ``uncond_drop``."""
        grads, loss, aux = self.forward_backward(batch, draws)
        if self.layout is not None:
            self._sum_grads(grads)
        stats = self._global_stats(loss, aux, grads)
        values = stats.tolist()  # the step's one host sync
        loss_f, gnorm = values[0], values[3]
        ok = np.isfinite(loss_f) and np.isfinite(gnorm)
        if ok or not self.cfg.skip_nonfinite_updates:
            self.optimizer.step(grads, stats[3])
        self.step += 1
        metrics = {"loss": loss_f, "grad_norm": gnorm}
        metrics.update({k: values[1 + i] for i, k in enumerate(METRIC_KEYS)
                        if k in aux})
        return metrics

    def fit(self, data_iter: Iterator[Dict[str, Any]],
            num_steps: Optional[int] = None,
            log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
            eval_fn: Optional[Callable[["Trainer"], Dict[str, float]]] = None,
            eval_every: int = 0,
            ) -> None:
        """Training loop over ``data_iter`` (its batches moved to the
        device as they are taken), logging every ``log_every`` steps and at
        the end, saving every ``save_every``.  ``eval_fn(trainer)`` runs
        every ``eval_every`` steps (the reference's evaluate-during-training,
        lmm_trainer.py:1174); its metrics are logged as ``eval/<name>``."""
        num_steps = num_steps or self.cfg.max_steps
        n = self.cfg.grad_accum_steps
        t0 = time.time()
        for i in range(num_steps):
            if n == 1:
                batch = to_device(next(data_iter), self.device)
            else:
                micro = [to_device(next(data_iter), self.device)
                         for _ in range(n)]
                batch = {k: (torch.stack([m[k] for m in micro])
                             if isinstance(micro[0][k], torch.Tensor)
                             else micro[0][k]) for k in micro[0]}
            metrics = self.train_step(batch)
            if log_fn and (self.step % self.cfg.log_every == 0
                           or i == num_steps - 1):
                metrics["steps_per_sec"] = (i + 1) / (time.time() - t0)
                log_fn(self.step, metrics)
            if eval_fn is not None and eval_every \
                    and self.step % eval_every == 0:
                eval_metrics = eval_fn(self)
                if log_fn and eval_metrics:
                    log_fn(self.step, {f"eval/{k}": v
                                       for k, v in eval_metrics.items()})
            self.maybe_save(data_state=(data_iter.state()
                                        if hasattr(data_iter, "state")
                                        else None))

    # checkpoints

    def _global(self, name: str, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The global tensor of this rank's part ``x`` of leaf ``name``, on
        the host of the writer (a collective on a mesh: every rank calls
        it; the others get None)."""
        if self.layout is not None:
            x = self.layout.gather(name, x.detach())
        return x.detach().to("cpu", copy=True) if self.writer else None

    def _local(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the global tensor ``x`` of ``name``."""
        return x if self.layout is None else self.layout.local(name, x)

    def _payload(self, data_state: Optional[Dict] = None) -> dict:
        """The checkpoint: on a mesh every leaf gathered (every rank takes
        part; rank 0 holds the tensors and writes them)."""
        opt = self.optimizer
        names = opt.names
        state = opt.state_dict()
        return dict(
            params={n: self._global(n, x) for n, x in zip(names, opt.masters)},
            opt_state=dict(count=state["count"], **{
                k: {n: self._global(n, state[k][n]) for n in names}
                for k in ("m", "v")}),
            step=self.step,
            seed=self.cfg.seed,
            load_from=self.load_from,
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
        the newest ``keep_checkpoints``; returns the file written.  On a
        mesh every rank calls it; rank 0 writes, and the ranks wait for the
        file."""
        if not self.cfg.checkpoint_dir:
            return None
        if not force and (self.cfg.save_every <= 0
                          or self.step % self.cfg.save_every):
            return None
        d = Path(self.cfg.checkpoint_dir)
        path = d / f"step_{self.step}.pt"
        payload = self._payload(data_state)
        if self.writer:
            d.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self._checkpoints()[:-self.cfg.keep_checkpoints]:
                old.unlink()
        del payload
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()
        return path

    @torch.no_grad()
    def _load_weights(self, params: Dict[str, torch.Tensor]) -> None:
        """Every weight of the model from the global ``params`` (strict:
        names and shapes), each rank its part."""
        if self.layout is None:
            self.model.load_state_dict(params, strict=True)
            return
        own = dict(self.model.named_parameters())
        if set(own) != set(params):
            raise KeyError(f"checkpoint names differ from the model's: "
                           f"{sorted(set(own) ^ set(params))[:4]}")
        for n, p in own.items():
            x = local_part(p)
            part = self._local(n, params[n])
            if part.shape != x.shape:
                raise ValueError(f"{n}: {tuple(part.shape)} in the "
                                 f"checkpoint, {tuple(x.shape)} here")
            x.copy_(part)

    @torch.no_grad()
    def warm_start(self, path: str) -> None:
        """Every weight of the model from the full checkpoint at ``path``
        (strict: names and shapes; on a mesh each rank its part), the fp32
        masters from the same values (not from the model's copies in its
        dtype); the moments and the update count stay as they are, fresh
        at step 0.  The file is recorded in the checkpoints: a resume
        rebuilds the frozen weights from it."""
        state = read_full_checkpoint(path)
        params = state["params"]
        self._load_weights(params)
        self.load_from = full_checkpoint_record(path, state)
        opt = self.optimizer
        for i, name in enumerate(opt.names):
            opt.set_master(i, self._local(name, params[name]))

    def restore(self, data_iter=None) -> bool:
        """Resume from the newest checkpoint: every weight from the full
        checkpoint the run was warm-started from (when it was), then the
        trainable parameters, the optimizer state, the step, the numpy RNG
        and, when ``data_iter`` has ``restore``, the data position.  On a
        mesh every rank reads the one file and takes its parts of it, so a
        checkpoint of any mesh resumes on any other.  Returns whether one
        was found."""
        found = self._checkpoints()
        if not found:
            return False
        state = torch.load(found[-1], map_location="cpu", weights_only=False)
        self.load_from = state.get("load_from")
        if self.load_from:
            self._load_weights(read_recorded_full(self.load_from)["params"])
        names = self.optimizer.names
        dev = self.device
        local = {n: self._local(n, state["params"][n]).to(dev) for n in names}
        opt_state = dict(state["opt_state"])
        for k in ("m", "v"):
            opt_state[k] = {n: self._local(n, opt_state[k][n]).to(dev)
                            for n in names}
        self.optimizer.load_state_dict(opt_state, local)
        self.step = int(state["step"])
        np.random.set_state(state["host_rng"])
        if data_iter is not None and hasattr(data_iter, "restore"):
            data_iter.restore(state["data_state"])
        return True
