"""Metric logging & profiling utilities.

Re-design of the reference `utils/misc.py:79-254` (`SmoothedValue`,
`MetricLogger`, rank-0 print) and the profiling plan of SURVEY.md §5.1:
smoothed meters, a TensorBoard writer hook, rank-0 printing, and
`torch.profiler` trace capture around training steps.

The port's copy of `mm_interleaved_tpu/utils/logging.py`: the rank is
`torch.distributed`'s when it is initialised, the parameter counts read a
`torch.nn.Module`, the trace is `torch.profiler`'s.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import time
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Window-smoothed + global-average meter (misc.py:79-130)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    """Iteration logger with smoothed meters and ETA (misc.py:133-237)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue
        )
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                eta = iter_time.global_avg * max(
                    getattr(iterable, "__length_hint__", lambda: 0)() - i, 0
                )
                self.print_fn(
                    f"{header} [{i}] {self} iter_time: {iter_time} "
                    f"eta: {datetime.timedelta(seconds=int(eta))}"
                )
            i += 1
            end = time.time()
        total = time.time() - start
        self.print_fn(
            f"{header} done in {datetime.timedelta(seconds=int(total))}"
        )


def rank() -> int:
    """This process's rank: `torch.distributed`'s when it is initialised,
    else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def print_parameters_stats(model, prefix: str = "", print_fn=print):
    """Per-top-level-module parameter counts, with the trainable ones
    (``requires_grad``; reference `print_parameters_stats`,
    mm_interleaved.py:110-119)."""
    for name, sub in model.named_children():
        params = list(sub.parameters())
        if not params:
            continue
        total = sum(p.numel() for p in params)
        trainable = sum(p.numel() for p in params if p.requires_grad)
        print_fn(f"# {prefix}{name} Total parameters: {total / 1e6:.2f}M"
                 f" | Trainable: {trainable / 1e6:.2f}M")


def rank0_print(*args, **kwargs):
    """Timestamped rank-0-only print (misc.py:240-254)."""
    if rank() == 0:
        ts = datetime.datetime.now().strftime("[%Y-%m-%d %H:%M:%S]")
        print(ts, *args, **kwargs)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """`torch.profiler` trace scope, written as a Chrome trace under
    ``log_dir``; no-op when log_dir is None (§5.1)."""
    if not log_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class TensorBoardWriter:
    """Thin tensorboard scalar writer (reference report_to: ['tensorboard']);
    degrades to JSONL when tensorboard isn't importable."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:
            import os

            os.makedirs(log_dir, exist_ok=True)
            self._w = None
            self._f = open(f"{log_dir}/scalars.jsonl", "a")

    def scalars(self, step: int, values: Dict[str, float]):
        if self._w is not None:
            for k, v in values.items():
                self._w.add_scalar(k, v, step)
        else:
            import json

            self._f.write(json.dumps({"step": step, **values}) + "\n")
            self._f.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
        else:
            self._f.close()
