"""What a ``--trace 1`` run reads: spans timed with CUDA events around the
program's calls (bound methods wrapped on the instance, forward hooks on
modules), the program's CUDA kernels' calls with their work at the call's
shapes, and a `torch.profiler` trace of a few whole units."""

from __future__ import annotations

import contextlib
import importlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from ..yardstick.work import BY_VALUE, WORK

# the op modules of the program that hold its kernels' wrappers
KERNEL_MODULES = ("flash_attention", "geglu", "group_norm",
                  "ms_deform_attn_cuda", "ms_deform_attn_mi", "quant")
PREFIX = "mmi::"


def _event():
    return torch.cuda.Event(enable_timing=True)


def replace_attr(obj, attr: str, value):
    """Set ``obj.attr`` on the instance; returns the function that puts
    back what the instance held before."""
    had = attr in vars(obj)
    before = vars(obj).get(attr)
    setattr(obj, attr, value)

    def undo():
        if had:
            setattr(obj, attr, before)
        elif attr in vars(obj):
            delattr(obj, attr)

    return undo


class Spans:
    """Spans by name around bound methods wrapped on their instance: each
    call inside a profiler range ``mmi::<name>`` (what the host was doing,
    for the idle gaps), and, where ``timed``, between two CUDA events;
    ``totals()`` after the window gives each timed name's summed
    milliseconds and its count."""

    def __init__(self):
        self.events: Dict[str, List[Tuple]] = defaultdict(list)
        self._undo = []

    def wrap(self, obj, attr: str, name: str, timed: bool) -> None:
        orig = getattr(obj, attr)
        events = self.events[name] if timed else None

        def wrapped(*a, **k):
            if events is None:
                with torch.profiler.record_function(PREFIX + name):
                    return orig(*a, **k)
            s, e = _event(), _event()
            s.record()
            with torch.profiler.record_function(PREFIX + name):
                out = orig(*a, **k)
            e.record()
            events.append((s, e))
            return out

        self._undo.append(replace_attr(obj, attr, wrapped))

    def totals(self) -> Dict[str, Tuple[float, int]]:
        torch.cuda.synchronize()
        return {n: (sum(s.elapsed_time(e) for s, e in ev), len(ev))
                for n, ev in self.events.items()}

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []


class Shape:
    """What the work counts read of a large tensor: its shape and dtype
    (no reference to its storage)."""

    def __init__(self, t: torch.Tensor):
        self.shape = t.shape
        self.dtype = t.dtype
        self._elem = t.element_size()

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self._elem


def light(x):
    """``x`` with every tensor replaced by its `Shape`."""
    if isinstance(x, torch.Tensor):
        return Shape(x)
    if isinstance(x, (tuple, list)):
        return type(x)(light(v) for v in x)
    if isinstance(x, dict):
        return {k: light(v) for k, v in x.items()}
    return x


class KernelCalls:
    """Wraps each of the program's kernel launchers (`CountedKernel`
    objects) so that every call runs inside a profiler range named after
    it and keeps its arguments' shapes, and the few small tensors whose
    values the counts read (`yardstick.work.BY_VALUE`); the work is
    counted after the traced units, so that counting launches nothing
    inside them and keeps no activation alive."""

    def __init__(self):
        self.calls: List[Tuple[str, tuple]] = []
        self._undo = []

    def install(self) -> None:
        from mm_interleaved_tpu_torch.ops.cuda_build import CountedKernel

        for mod_name in KERNEL_MODULES:
            mod = importlib.import_module(
                f"mm_interleaved_tpu_torch.ops.{mod_name}")
            for attr, obj in vars(mod).items():
                if isinstance(obj, CountedKernel) and attr in WORK:
                    self._wrap(obj, attr)

    def _wrap(self, kernel, name: str) -> None:
        orig = kernel._launch
        calls = self.calls
        keep = BY_VALUE.get(name, ())

        def launch(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + "kernel:" + name):
                out = orig(*args, **kwargs)
            calls.append((
                name,
                tuple(a if i in keep else light(a)
                      for i, a in enumerate(args)),
                {k: v if k in keep else light(v)
                 for k, v in kwargs.items()},
                light(out)))
            return out

        kernel._launch = launch
        self._undo.append(lambda: setattr(kernel, "_launch", orig))

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def bounds_s(self) -> Dict[str, float]:
        """Each kernel's summed bound time (s) over its calls; a kernel
        whose work could not be counted is left out."""
        from ..yardstick.peaks import bound_s

        out: Dict[str, float] = defaultdict(float)
        bad = set()
        for name, args, kwargs, result in self.calls:
            try:
                flops, nbytes, peak = WORK[name](args, kwargs, result)
            except (TypeError, ValueError, IndexError, AttributeError):
                bad.add(name)  # a launcher whose arguments changed
                continue
            out[name] += bound_s(float(flops), float(nbytes), peak)
        for name in bad:
            out.pop(name, None)
        return dict(out)


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of ``[start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[float, float]], start: float, end: float):
    """The idle gaps ``(start, end)`` between the union of ``intervals``
    inside ``[start, end]``."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def read_profile(prof) -> dict:
    """From a finished profiler run over whole units (each inside a
    ``mmi::unit`` range): the device's busy and wall seconds, device time
    by kernel name, each of the program's kernels' device seconds (the
    device side of its ``mmi::kernel:`` ranges), and the longest idle
    gaps, each named by the innermost host-side ``mmi::`` range open at
    the gap's start."""
    events = prof.events()
    kernels, ranges, units = [], [], []
    by_name: Dict[str, float] = defaultdict(float)
    ours: Dict[str, float] = defaultdict(float)
    for ev in events:
        tr = ev.time_range
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if on_device and ev.name.startswith(PREFIX):
            # the device side of a range (a user annotation): from the
            # first to the last kernel launched inside it
            if ev.name.startswith(PREFIX + "kernel:"):
                ours[ev.name[len(PREFIX + "kernel:"):]] += \
                    (tr.end - tr.start) / 1e6
        elif on_device:
            kernels.append((tr.start, tr.end))
            by_name[ev.name] += (tr.end - tr.start) / 1e6
        elif ev.name == PREFIX + "unit":
            units.append((tr.start, tr.end))
        elif ev.name.startswith(PREFIX):
            ranges.append((tr.start, tr.end, ev.name[len(PREFIX):]))
    if not kernels or not units:
        return {}
    w0 = min(s for s, _ in units)
    w1 = max(max(e for _, e in units), max(e for _, e in kernels))
    inside = [(max(s, w0), min(e, w1)) for s, e in kernels
              if e > w0 and s < w1]
    busy = union_length(inside) / 1e6
    idle = []
    for s, e in gaps(inside, w0, w1):
        host = [r for r in ranges if r[0] <= s < r[1]]
        label = (min(host, key=lambda r: r[1] - r[0])[2] if host
                 else "between calls")
        idle.append((label, (e - s) / 1e6))
    idle.sort(key=lambda x: -x[1])
    ops = sorted(by_name.items(), key=lambda x: -x[1])
    return dict(busy_s=busy, window_s=(w1 - w0) / 1e6,
                device_ops=[[n[:120], s] for n, s in ops[:10]],
                idle_gaps=[[n, s] for n, s in idle[:10]],
                kernel_device_s=dict(ours), device_s_by_name=dict(by_name))


@contextlib.contextmanager
def profiled():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
