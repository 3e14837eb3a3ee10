"""The per-layer readers on hand-made readings: each reads its spans,
trace or count, and returns nothing where the run holds nothing."""

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import gaps, union_length


def read(name, readings):
    return spec.metric_reader(name).read(readings, spec.split_of(name))


def test_spans_per_call():
    r = dict(spans={"unet": (900.0, 10), "decode_step": (500.0, 5),
                    "prefill": (40.0, 2), "encode": (30.0, 3),
                    "context": (10.0, 4)})
    assert read("denoise_step_ms.t2i", r) == 90.0
    assert read("decode_step_ms.vqa", r) == 100.0
    assert read("prefill_ms.vqa", r) == 20.0
    assert read("encode_ms.vqa", r) == 10.0
    assert read("context_ms.t2i", r) == 2.5
    assert read("decode_step_ms.vqa", dict(spans={})) is None


def test_mfu():
    r = dict(unit_flops=989e12 * 0.5, units=10, window_s=20.0)
    assert read("mfu.t2i", r) == pytest.approx(25.0)
    assert read("mfu.vqa", dict(units=1, window_s=1.0)) is None


def test_rooflines():
    r = dict(kernel_bounds_s={"flash_attention": 0.1, "geglu_cuda": 0.2,
                              "int8_linear_cuda": 0.3},
             profile=dict(kernel_device_s={"flash_attention": 0.4,
                                           "geglu_cuda": 0.4,
                                           "int8_linear_cuda": 0.6,
                                           "other": 1.0}))
    assert read("kernel_roofline.t2i", r) == pytest.approx(100 * 0.6 / 1.4)
    assert read("int8_linear_roofline.vqa", r) == pytest.approx(50.0)
    r2 = dict(kernel_bounds_s={"geglu_cuda": 0.2},
              profile=dict(kernel_device_s={"geglu_cuda": 0.4}))
    assert read("int8_linear_roofline.vqa", r2) is None


def test_idle_share_and_unions():
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    # 2 profiled units busy 3 s on the device; the window's units took
    # 2 s each
    r = dict(profile=dict(busy_s=3.0, window_s=6.0), profile_units=2,
             units=10, window_s=20.0)
    assert read("idle_share.t2i", r) == pytest.approx(25.0)
    assert read("idle_share.vqa", dict(profile={})) is None
