"""`BENCHMARK.json` against the benchmark's contract, and the lookup of
configurations, mixes, metric readers and limits by name."""

import json
import re

import pytest

from benchmark.harness import check, spec
from benchmark.harness.dataclass_dict import from_dict

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_e2e_and_a_layer():
    cells = [w["name"] for w in BENCH["workloads"]]
    for c in cells:
        e2e = {m["name"] for m in spec.metrics_of(c, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics_of(c, "per_layer")
        assert layers
        for m in layers:  # each moves an end-to-end metric its cells report
            assert m["moves"] in e2e


def test_configs_are_their_files():
    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import \
        MMInterleavedConfig

    for c in BENCH["configs"]:
        s = spec.config_spec(c["name"])
        assert s["reduced"] == c["reduced"] == []
        assert s["source"] == c["source"]
        # exactly the port's flagship preset, as published
        assert from_dict(MMInterleavedConfig, s["model"]) == flagship_config()
    assert spec.config_spec("mmi13b-int8")["quantize"] == "int8"
    assert spec.config_spec("mmi13b")["quantize"] is None


def test_mixes_metrics_and_limits_by_name():
    for w in BENCH["workloads"]:
        assert spec.traffic_spec(w["traffic"])["name"] == w["traffic"]
        assert check.limits(w["name"])
    for m in BENCH["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert reader.read({}, spec.split_of(m["name"])) is None
    with pytest.raises(KeyError):
        spec.metric_reader("no_such_metric.t2i")
    with pytest.raises(KeyError):
        spec.cell("no.such-cell")


def test_split_names():
    assert spec.split_of("mfu.t2i") == "t2i"
    assert spec.split_of("setup_s") == ""
