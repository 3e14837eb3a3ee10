"""Timing a CUDA call three ways, and the H100's peak rates that bound it
(`chip_smoke.py` and `bench_unet_kernels`).

* `time_ms`: the median of synchronised CUDA-event runs (host gaps
  included);
* `device_ms`: device time under `torch.profiler`, the sum of every kernel
  the call launches (`device_ms_by_kernel`: by kernel);
* `queued_ms`: the mean of calls enqueued back to back between two events
  (the device time where the card is slower than the host's calls, else
  the host's time a call).
"""

from __future__ import annotations

from typing import Optional

import subprocess

import numpy as np
import torch

RUNS = 25
PEAK_BF16_FLOPS = 989e12  # dense tensor-core bf16, H100 SXM
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(fn, runs: int = RUNS) -> float:
    """Median of ``runs`` synchronised CUDA-event runs after a warm-up."""
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


def queued_ms(fn, runs: int = RUNS) -> float:
    """The mean time of ``runs`` calls of ``fn`` enqueued back to back
    between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_kernels(prof) -> dict:
    """Device time (ms) and launches by kernel name from a finished
    `torch.profiler` run."""
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        ms_n = out.setdefault(ev.key, [0.0, 0])
        ms_n[0] += t / 1e3
        ms_n[1] += ev.count
    return out


def device_ms_by_kernel(fn, runs: int = 10,
                        tries: int = 3) -> Optional[dict]:
    """Device time of one call of ``fn`` by kernel name: the time of each
    kernel it launches under `torch.profiler`, summed over ``runs`` calls,
    divided by ``runs``.  Unlike a CUDA-event time it leaves out the host's
    gaps between launches.  The profiler drops kernel records now and then
    in a long process, so a reading counts only where every kernel was
    recorded a whole multiple of ``runs`` times; after ``tries`` incomplete
    readings it returns None."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        by_kernel = device_kernels(prof)
        counts = {k[:60]: n for k, (_, n) in by_kernel.items()}
        if by_kernel and all(n > 0 and n % runs == 0
                             for n in counts.values()):
            return {k: ms / runs for k, (ms, _) in by_kernel.items()}
        print(f"device_ms: incomplete profiler reading {counts}", flush=True)
    return None


def device_ms(fn, runs: int = 10, tries: int = 3) -> Optional[float]:
    """The sum of `device_ms_by_kernel`, or None."""
    by_kernel = device_ms_by_kernel(fn, runs, tries)
    return None if by_kernel is None else sum(by_kernel.values())
