"""Sharded streaming input: deterministic shuffles, host/worker splits,
jsonl/tar shard readers.

Re-design of the reference webdataset plumbing (`custom_datasets/wds_utils.py`:
`detshuffle2` :567-596, `ResampledShards2` :599-642,
`jsonl_to_samples_nothrow` :150-183; `mmc4_wds.py:218-227` shard splitting) —
a thin pure-python pipeline (no torch DataLoader workers; parallelism comes
from per-host sharding + an optional thread prefetcher).

Every stage is deterministic given (seed, epoch) — the reproducibility
contract `detshuffle2` provides in the reference.

The port's copy of `mm_interleaved_tpu/data/shards.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import io
import json
import re
import tarfile
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


def expand_braces(pattern: str) -> List[str]:
    """'{0000..0003}.tar' -> ['0000.tar', ..., '0003.tar'] (wds syntax)."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        out.extend(
            expand_braces(
                pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
            )
        )
    return out


def det_shuffle(items: Sequence, seed: int, epoch: int) -> List:
    """Deterministic (seed, epoch) shuffle (detshuffle2 semantics)."""
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, epoch]).generate_state(4)
    )
    items = list(items)
    rng.shuffle(items)
    return items


def split_by_host_and_worker(
    items: Sequence,
    host_id: int = 0,
    num_hosts: int = 1,
    worker_id: int = 0,
    num_workers: int = 1,
) -> List:
    """Strided shard assignment (split_by_node/split_by_worker analogue)."""
    items = list(items)[host_id::num_hosts]
    return items[worker_id::num_workers]


def read_jsonl_shard(path: str) -> Iterator[dict]:
    """A shard = a .jsonl file (optionally inside a .zip holding one member),
    one json document per line (jsonl_to_samples_nothrow, wds_utils.py:150-183).
    Errors are logged and swallowed (log_and_continue semantics)."""
    try:
        if path.endswith(".zip"):
            import zipfile

            with zipfile.ZipFile(path) as zf:
                name = zf.namelist()[0]
                with zf.open(name) as f:
                    for line in io.TextIOWrapper(f, encoding="utf-8"):
                        if line.strip():
                            yield json.loads(line)
        else:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    if line.strip():
                        yield json.loads(line)
    except Exception as e:  # noqa: BLE001 — data fault tolerance by design
        print(f"[shards] skipping shard {path}: {e!r}")


def read_tar_shard(path: str) -> Iterator[dict]:
    """webdataset-style tar shard -> dicts grouped by key
    (tarfile_to_samples_nothrow, wds_utils.py:100-140)."""
    try:
        with tarfile.open(path) as tf:
            current_key, sample = None, {}
            for member in tf:
                if not member.isfile():
                    continue
                key, _, ext = member.name.partition(".")
                if key != current_key and sample:
                    yield sample
                    sample = {}
                current_key = key
                sample["__key__"] = key
                data = tf.extractfile(member).read()
                sample[ext] = data
            if sample:
                yield sample
    except Exception as e:  # noqa: BLE001
        print(f"[shards] skipping shard {path}: {e!r}")


@dataclass
class ShardedStream:
    """Deterministic sharded sample stream.

    One instance per (host, worker); iterate per epoch via `iterate(epoch)`.
    """

    shard_pattern: str
    shard_reader: Callable[[str], Iterator] = read_jsonl_shard
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    worker_id: int = 0
    num_workers: int = 1
    shuffle_shards: bool = True
    sample_buffer: int = 0  # in-memory sample shuffle buffer size
    resample: bool = False  # sample shards with replacement (ResampledShards2)

    def shards_for_epoch(self, epoch: int) -> List[str]:
        shards = expand_braces(self.shard_pattern)
        if self.resample:
            rng = np.random.RandomState(
                np.random.SeedSequence([self.seed, epoch]).generate_state(4)
            )
            shards = list(rng.choice(shards, size=len(shards), replace=True))
        elif self.shuffle_shards:
            shards = det_shuffle(shards, self.seed, epoch)
        return split_by_host_and_worker(
            shards, self.host_id, self.num_hosts,
            self.worker_id, self.num_workers,
        )

    def iterate(self, epoch: int = 0) -> Iterator:
        rng = np.random.RandomState(
            np.random.SeedSequence(
                [self.seed + 1, epoch, self.host_id, self.worker_id]
            ).generate_state(4)
        )
        buf: List = []
        for shard in self.shards_for_epoch(epoch):
            for sample in self.shard_reader(shard):
                if self.sample_buffer <= 0:
                    yield sample
                    continue
                buf.append(sample)
                if len(buf) >= self.sample_buffer:
                    idx = rng.randint(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
        rng.shuffle(buf)
        yield from buf
