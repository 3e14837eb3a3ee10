"""Everything the harness finds by name: `BENCHMARK.json` at the root of
the checkout, a configuration's file under ``benchmark/configs/``, a
traffic mix's under ``benchmark/traffic/`` and a per-layer metric's reader
under ``benchmark/metrics/``.  A later change adds a configuration, a mix
or a metric as a new file of that name; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_spec(name: str) -> dict:
    spec = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    if spec["name"] != name:
        raise ValueError(f"configs/{name}.json names {spec['name']!r}")
    return spec


def traffic_spec(name: str) -> dict:
    spec = json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())
    if spec["name"] != name:
        raise ValueError(f"traffic/{name}.json names {spec['name']!r}")
    return spec


def _load(path: Path) -> ModuleType:
    mod_name = "benchmark_metric_" + path.stem.replace(".", "_").replace(
        "-", "_")
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    for a split name ``<base>.<split>``, ``metrics/<base>.py``.  Its
    ``read(readings, split)`` returns the value, or None where the run
    holds nothing to read."""
    whole = BENCH_DIR / "metrics" / f"{name}.py"
    if whole.exists():
        return _load(whole)
    base = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    if base.exists():
        return _load(base)
    raise KeyError(f"no reader for metric {name!r} under benchmark/metrics/")


def split_of(name: str) -> str:
    """``t2i`` of ``mfu.t2i``; "" for a name without a split."""
    return name.split(".", 1)[1] if "." in name else ""


def metrics_of(cell_name: str, kind: str, bench: dict = None) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``cell_name`` reports: those that list it, and those without a
    ``workloads`` key."""
    bench = bench or benchmark()
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
