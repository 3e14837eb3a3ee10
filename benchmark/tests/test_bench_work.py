"""The frozen operation and byte counts against hand-computed values at
tiny shapes, and the bound arithmetic."""

import pytest
import torch

from benchmark.yardstick import peaks, work


def test_flash_dense_and_causal():
    q = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 5, 4, 8, dtype=torch.bfloat16)
    out = torch.zeros_like(q)
    f, b, p = work.flash_fwd((q, k, k), {}, out)
    assert f == 4 * 2 * 3 * 5 * 4 * 8
    assert b == 2 * (q.numel() + 2 * k.numel() + out.numel())
    assert p == peaks.PEAK_BF16_FLOPS
    # causal, aligned to the end of 5 keys: queries see 3, 4, 5 keys
    f, _, _ = work.flash_fwd((q, k, k), {"causal": True}, out)
    assert int(f) == 4 * 2 * (3 + 4 + 5) * 4 * 8
    seg_q = torch.tensor([[0, 0, 1]] * 2)
    seg_k = torch.tensor([[0, 1, 1, 1, 1]] * 2)
    f, _, _ = work.flash_fwd((q, k, k), {"q_segment_ids": seg_q,
                                         "kv_segment_ids": seg_k}, out)
    assert int(f) == 4 * 2 * (1 + 1 + 4) * 4 * 8


def test_flash_backward_is_ten_per_pair():
    q = torch.zeros(1, 2, 1, 4, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 2)
    f, b, _ = work.flash_bwd((q, q, q, q, lse), {}, (q, q, q))
    assert f == 10 * 2 * 2 * 4
    assert b == 2 * 4 * 8 + 4 * 2 + 3 * 2 * 8


def test_int8_linear():
    x = torch.zeros(3, 16, dtype=torch.bfloat16)
    q = torch.zeros(32, 16, dtype=torch.int8)
    s = torch.zeros(32)
    f, b, p = work.int8_linear((x, q, s, None), {}, None)
    assert f == 2 * 3 * 32 * 16
    assert b == 3 * 16 * 2 + 32 * 16 + 32 * 4 + 3 * 32 * 2
    assert p == peaks.PEAK_BF16_FLOPS


def test_geglu_and_group_norm():
    x = torch.zeros(2, 5, 8, dtype=torch.bfloat16)
    w1, b1 = torch.zeros(64, 8), torch.zeros(64)
    w2, b2 = torch.zeros(8, 32), torch.zeros(8)
    f, _, _ = work.geglu_fwd((x, w1, b1, w2, b2), {}, x)
    assert f == 6 * 10 * 8 * 32
    g = torch.zeros(2, 4, 4, 8)
    wb = torch.zeros(2, 2, 8)
    f, b, p = work.gn_moments((g, torch.zeros(8), torch.zeros(8)), {}, wb)
    assert (f, b, p) == (3 * 256, 4 * (256 + 16 + 32), peaks.PEAK_FP32_FLOPS)
    f, b, _ = work.gn_apply((g, wb, True), {}, g)
    assert (f, b) == (3 * 256, 4 * (256 + 32 + 256))


def test_deform_forward_touches_at_most_the_value():
    value = torch.zeros(1, 20, 2, 4)  # 20 texels, 2 heads, D = 4
    loc = torch.zeros(1, 3, 2, 1, 2, 2)  # 3 queries, 1 level, 2 points
    w = torch.zeros(1, 3, 2, 1, 2)
    out = torch.zeros(1, 3, 8)
    f, b, _ = work.deform_fwd((value, ((4, 5),), loc, w), {}, out)
    samples = 3 * 2 * 2
    assert f == 8 * samples * 4
    assert b == 4 * min(value.numel(), 4 * samples * 4) + 4 * (
        loc.numel() + w.numel() + out.numel())


def test_mi_counts_live_images():
    Bv, n_img, S, H, D, L, P, Lq = 1, 2, 5, 2, 4, 1, 2, 3
    value = torch.zeros(Bv, n_img, S, H, D)
    delta = torch.zeros(Bv, H, n_img, L * P * 3)
    delta[..., 0, 2::3] = 1.0  # image 0 live in every head
    ref = torch.zeros(Bv, Lq, 2)
    off_q = torch.zeros(Bv, Lq, H, P, 2)
    wq = torch.zeros(Bv, Lq, H, L, P)
    out = torch.zeros(Bv, Lq, H * D)
    f, _, _ = work.mi_fwd((value, delta, ((1, 5),), ref, off_q, wq, 1.0),
                          {}, out)
    assert int(f) == 8 * (H * 1) * Lq * L * P * D


def test_bound_takes_the_slower_side():
    assert peaks.bound_s(989e12, 0, peaks.PEAK_BF16_FLOPS) == 1.0
    assert peaks.bound_s(0, 3.35e12, peaks.PEAK_BF16_FLOPS) == 1.0
    assert peaks.bound_s(67e12, 3.35e12 * 0.5, peaks.PEAK_FP32_FLOPS) \
        == pytest.approx(1.0)


def test_every_kernel_of_the_program_has_its_count():
    from mm_interleaved_tpu_torch.ops.cuda_build import CountedKernel

    from benchmark.harness.trace import KERNEL_MODULES
    import importlib

    names = set()
    for m in KERNEL_MODULES:
        mod = importlib.import_module(f"mm_interleaved_tpu_torch.ops.{m}")
        names |= {a for a, o in vars(mod).items()
                  if isinstance(o, CountedKernel)}
    assert names == set(work.WORK)


def test_counts_read_shapes_of_large_tensors():
    from benchmark.harness.trace import Shape, light

    x = torch.zeros(3, 16, dtype=torch.bfloat16)
    q = torch.zeros(32, 16, dtype=torch.int8)
    s = torch.zeros(32)
    want = work.int8_linear((x, q, s, None), {}, None)
    big = torch.zeros(1100, 1000)
    assert isinstance(light(big), Shape) and isinstance(light(s), Shape)
    assert light(big).numel() == 1100 * 1000
    assert work.int8_linear((Shape(x), Shape(q), Shape(s), None), {},
                            None) == want


def test_counts_by_value_take_their_arguments_whole():
    from benchmark.harness.trace import light

    q = light(torch.zeros(1, 3, 2, 8, dtype=torch.bfloat16))
    seg = torch.tensor([[0, 0, 1]])
    f, _, _ = work.flash_fwd((q, q, q), {"q_segment_ids": seg,
                                         "kv_segment_ids": seg}, q)
    assert int(f) == 4 * (2 * 2 + 1) * 2 * 8
