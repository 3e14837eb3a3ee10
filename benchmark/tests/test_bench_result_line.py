"""The last line's shape: the contract's keys, the cell's metrics for the
run's kind, the device, and the checks last."""

import json

import pytest
import torch

from benchmark.harness import report


@pytest.fixture
def res():
    return dict(setup_s=61.5, requests=240, window_s=40.2,
                latencies_s=[2.0] * 240, memory_peak_bytes=5 * 2 ** 30,
                units=20, unit_flops=1e15, profile_units=2,
                spans={"prefill": (4000.0, 20), "encode": (3000.0, 20),
                       "decode_step": (18000.0, 180)},
                kernel_bounds_s={"int8_linear_cuda": 0.1},
                profile=dict(busy_s=2.0, window_s=3.0,
                             kernel_device_s={"int8_linear_cuda": 0.4},
                             device_ops=[["k", 0.5]],
                             idle_gaps=[["decode_step", 0.01]]),
                checks=[dict(name="logprob_gap", value=0.1, limit=0.5)])


@pytest.fixture(autouse=True)
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")


def test_plain_run(res):
    line = report.result_line("mmi13b-int8.vqa8shot-b12", res, False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 240
    assert set(line["metrics"]) == {"answers_per_s", "answer_ms_p95",
                                    "setup_s"}
    assert line["metrics"]["answers_per_s"] == dict(
        value=240 / 40.2, unit="answers/s")
    assert line["device"] == dict(platform="gpu",
                                  kind="NVIDIA H100 80GB HBM3", count=1,
                                  memory_peak_bytes=5 * 2 ** 30)
    json.dumps(line)


def test_traced_run(res):
    line = report.result_line("mmi13b-int8.vqa8shot-b12", res, True)
    assert list(line)[-1] == "checks" and "breakdown" in line
    m = line["metrics"]
    assert set(m) == {"encode_ms.vqa", "prefill_ms.vqa",
                      "decode_step_ms.vqa", "mfu.vqa", "kernel_roofline.vqa",
                      "int8_linear_roofline.vqa", "idle_share.vqa"}
    assert m["idle_share.vqa"]["unit"] == "%"
    assert line["device"]["busy_s"] == 2.0
    assert line["device"]["window_s"] == 3.0


def test_a_check_over_its_limit_is_not_correct(res):
    res["checks"][0]["value"] = 0.6
    assert report.result_line("mmi13b-int8.vqa8shot-b12", res,
                              False)["correct"] is False
    res["checks"][0]["value"] = float("nan")
    assert report.correct(res["checks"]) is False
    assert report.correct([]) is False
