"""Multi-process ordered map for the host-side data pipeline.

The reference leans on torch ``DataLoader(num_workers=N)`` to hide image
decode/transform cost behind the train step (`lmm_trainer.py` wds loaders);
here the analogue is :func:`mp_map` — an order-preserving parallel map over
an iterator, forked workers, bounded in-flight queue — applied to the
heavy per-document step (`pipeline._doc_to_sample`: JPEG decode + native
bicubic + tokenize).  ``num_workers=0`` (default) is a plain inline map,
byte-identical output; any worker count yields the same stream because
each document carries its own RNG seed (drawn sequentially by the parent).

Fork start method only (Linux): the mapped function and its closures are
inherited, never pickled; queue items (documents/samples: bytes + numpy
arrays) must be picklable, which they are.

The workers run the numpy/PIL data path only and never touch
``torch.cuda``: they fork from a process that may hold a CUDA context,
which a forked child must not use.

The port's copy of `mm_interleaved_tpu/data/mp_loader.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_STOP = "__mmi_mp_stop__"


def _worker(fn, in_q, out_q):
    while True:
        item = in_q.get()
        if item == _STOP:
            return
        idx, payload = item
        try:
            out_q.put((idx, "ok", fn(payload)))
        except Exception as e:  # noqa: BLE001 — relayed to the parent
            out_q.put((idx, "err", f"{type(e).__name__}: {e}"))


def mp_map(
    fn: Callable[[T], U],
    iterable: Iterator[T],
    num_workers: int = 0,
    inflight_per_worker: int = 4,
) -> Iterator[U]:
    """Ordered parallel map. ``num_workers=0`` -> ``map(fn, iterable)``.

    Results are yielded strictly in input order (a reorder buffer holds
    early completions), so worker count never changes the stream.  Worker
    exceptions re-raise in the parent with the original message.
    """
    if num_workers <= 0:
        yield from map(fn, iterable)
        return

    ctx = mp.get_context("fork")
    in_q = ctx.Queue()
    out_q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker, args=(fn, in_q, out_q), daemon=True)
        for _ in range(num_workers)
    ]
    for p in procs:
        p.start()

    max_inflight = num_workers * inflight_per_worker
    src = enumerate(iterable)
    pending = {}  # idx -> result (completed out-of-order)
    next_out = 0
    submitted = 0
    exhausted = False

    def _drain_one():
        nonlocal next_out
        idx, status, value = out_q.get()
        if status == "err":
            raise RuntimeError(f"mp_map worker failed on item {idx}: {value}")
        pending[idx] = value

    try:
        while True:
            while not exhausted and submitted - next_out < max_inflight:
                try:
                    idx, item = next(src)
                except StopIteration:
                    exhausted = True
                    break
                in_q.put((idx, item))
                submitted += 1
            if next_out == submitted and exhausted:
                return
            while next_out not in pending:
                _drain_one()
            value = pending.pop(next_out)
            next_out += 1
            yield value
    finally:
        for _ in procs:
            in_q.put(_STOP)
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
