"""The result line: the cell's end-to-end metrics (``--trace 0``) or
per-layer metrics (``--trace 1``) from a run's readings, the device, and
last the checks."""

from __future__ import annotations

import math

import torch

from . import spec, stats

E2E = {
    "setup_s": lambda r: r["setup_s"],
    "images_per_s": lambda r: stats.rate(r["requests"], r["window_s"]),
    "answers_per_s": lambda r: stats.rate(r["requests"], r["window_s"]),
    "answer_ms_p95": lambda r: 1e3 * stats.percentile(r["latencies_s"], 95),
}


def correct(checks) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)


def device_info(res: dict, trace: bool) -> dict:
    d = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
             memory_peak_bytes=int(res["memory_peak_bytes"]))
    if trace and res.get("profile"):
        d.update(busy_s=res["profile"]["busy_s"],
                 window_s=res["profile"]["window_s"])
    return d


def metrics(cell_name: str, res: dict, trace: bool) -> dict:
    out = {}
    if not trace:
        for m in spec.metrics_of(cell_name, "end_to_end"):
            out[m["name"]] = dict(value=E2E[m["name"]](res), unit=m["unit"])
        return out
    for m in spec.metrics_of(cell_name, "per_layer"):
        v = spec.metric_reader(m["name"]).read(res, spec.split_of(m["name"]))
        if v is not None:
            out[m["name"]] = dict(value=v, unit=m["unit"])
    return out


def result_line(cell_name: str, res: dict, trace: bool) -> dict:
    checks = res["checks"]
    line = dict(correct=correct(checks), attempted=res["requests"],
                failed=res.get("failed", 0),
                metrics=metrics(cell_name, res, trace),
                device=device_info(res, trace))
    if trace and res.get("profile"):
        line["breakdown"] = dict(device_ops=res["profile"]["device_ops"],
                                 idle_gaps=res["profile"]["idle_gaps"])
    line["checks"] = {c["name"]: dict(value=c["value"], limit=c["limit"])
                      for c in checks}
    return line
