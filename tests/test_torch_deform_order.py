"""The deformable kernels' fixed-order designs, emulated on the CPU.

The value gradient (kernel 2, ``csrc/ms_deform_attn_bwd.cu``) bins each
(n, h, level)'s samples by cell, stably, and gathers every texel's gradient
by walking its four cells in a fixed order; no float atomics, so the
gradient is the same bits every run.  `emulate_value_grad` replays that
plan in numpy: the cell keys with the kernel's rounding, the binning warp
by warp (counts per warp, offsets in warp order, the scan, placement in
sample order), and the walk in the kernel's order and lane split.  It is
held against autograd through `ms_deform_attn_plain` and against the JAX
package's Pallas v5 backward in interpret mode, fp32, within 1e-6 of the
gradient's scale, at clustered and uniform locations, every sample in one
cell, every corner out of bounds, and L * P = 9.

Also here: the pure functions that pick the bodies (`forward_variant`,
`value_grad_plan`) at the flagship's and the tiny preset's widths, the
binning's integer division, the refusals before any launch, and the edge
cases `chip_smoke.py` holds the kernels to on the card.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops.ms_deform_attn_pallas_v5 import (
    _ms_deform_attn_pallas_v5_bwd,
)
from mm_interleaved_tpu_torch import bench_unet_kernels as bench
from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as kmod

from _torch_parity import t

BF16, FP32 = torch.bfloat16, torch.float32
F32 = np.float32
UNET = ((64, 64), (32, 32), (16, 16), (8, 8))
LLM = ((32, 32), (16, 16), (8, 8))
REL = 1e-6


# --------------------------------------------------------------------------
# the emulation


def cell_keys(loc_l, hl, wl):
    """The cell of each sample of one level (x0 + 1, y0 + 1 in a (wl + 1)
    wide grid), -1 where no corner is in bounds: x = loc * W - 0.5 rounded
    as a product, then a difference, in fp32, as the kernel rounds it."""
    x = (loc_l[..., 0].astype(F32) * F32(wl)).astype(F32) - F32(0.5)
    y = (loc_l[..., 1].astype(F32) * F32(hl)).astype(F32) - F32(0.5)
    x0, y0 = np.floor(x), np.floor(y)
    ok = (x0 >= -1) & (x0 <= wl - 1) & (y0 >= -1) & (y0 <= hl - 1)
    key = (y0 + 1) * (wl + 1) + x0 + 1
    return np.where(ok, key, -1).astype(np.int64), x - x0, y - y0


def bin_level(keys, cells, warps):
    """One binning CTA: ``keys`` of the level's samples in sample order;
    returns ``(ids, starts)``: the sample ids cell after cell, and where
    each of the ``cells`` begins (``starts[cells]``: the number placed)."""
    seg = -(-len(keys) // warps)
    runs = [keys[w * seg:(w + 1) * seg] for w in range(warps)]
    counts = np.zeros((warps, cells), np.int64)
    for w, run in enumerate(runs):  # 1. each warp its row
        np.add.at(counts[w], run[run >= 0], 1)
    offsets = np.cumsum(counts, 0) - counts  # 2. in warp order
    totals = counts.sum(0)
    starts = np.concatenate([[0], np.cumsum(totals)])  # 3. the scan
    cursor = offsets + starts[None, :-1]
    ids = np.full(len(keys), -1, np.int64)
    for w, run in enumerate(runs):  # 4. placement, 32 lanes a step
        for base in range(0, len(run), 32):
            step = run[base:base + 32]
            for lane, key in enumerate(step):
                if key < 0:
                    continue
                rank = int((step[:lane] == key).sum())  # lanes below, same cell
                ids[cursor[w, key] + rank] = w * seg + base + lane
            for key in np.unique(step[step >= 0]):
                cursor[w, key] += int((step == key).sum())
    return ids[:starts[-1]], starts


def walk_sum(samples, coefs, rows, mode, G):
    """The fp32 sum of ``coefs[j] * rows[j]`` over a texel's walk in the
    kernel's order: "group", one after another; "warp", the groups of G
    lanes taking every (32 / G)-th sample of each round of 2 * 32, their
    sums folded by the butterfly."""
    D = rows.shape[-1]
    if mode == "group":
        acc = np.zeros(D, F32)
        for j in samples:
            acc = (acc + F32(coefs[j]) * rows[j]).astype(F32)
        return acc
    NG = 32 // G
    parts = np.zeros((NG, D), F32)
    for base in range(0, len(samples), 64):
        for k in range(64 // NG):
            for g in range(NG):
                s = base + k * NG + g
                if s < len(samples):
                    j = samples[s]
                    parts[g] = (parts[g] + F32(coefs[j]) * rows[j]).astype(F32)
    off = 1
    while off < NG:  # the butterfly: partners off apart, in lane order
        parts = np.stack([(parts[g] + parts[g ^ off]).astype(F32)
                          for g in range(NG)])
        off *= 2
    return parts[0]


def emulate_value_grad(value_shape, shapes, loc, w, dout, dtype=FP32):
    """Kernel 2's plan in numpy: ``(grad_value, ids, starts)`` where
    ``ids[n][h][l]`` and ``starts[n][h][l]`` are each binning CTA's
    output."""
    N, S, H, D = value_shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    plan = kmod.value_grad_plan(shapes, Q, L, P, D, dtype)
    G = kmod._group_lanes(D, dtype) or 32
    dout = dout.reshape(N, Q, H, D).astype(F32)
    grad = np.zeros((N, S, H, D), F32)
    all_ids, all_starts = {}, {}
    start = 0
    for l, (hl, wl) in enumerate(shapes):
        cells = (hl + 1) * (wl + 1)
        for n in range(N):
            for h in range(H):
                lo = loc[n, :, h, l].reshape(Q * P, 2)  # i = q * P + p
                keys, fx, fy = cell_keys(lo, hl, wl)
                ids, starts = bin_level(keys, cells, plan.bin_warps)
                all_ids[n, h, l], all_starts[n, h, l] = ids, starts
                ww = w[n, :, h, l].reshape(Q * P).astype(F32)
                rows = dout[n, np.arange(Q * P) // P, h]
                for ty in range(hl):
                    for tx in range(wl):
                        walk, coefs = [], {}
                        for c in range(4):  # the cells in the kernel's order
                            dx, dy = c & 1, c >> 1
                            key = (ty - dy + 1) * (wl + 1) + tx - dx + 1
                            for i in ids[starts[key]:starts[key + 1]]:
                                wx = fx[i] if dx else F32(1) - fx[i]
                                wy = fy[i] if dy else F32(1) - fy[i]
                                coefs[len(walk)] = ww[i] * F32(wx * wy)
                                walk.append(i)
                        grad[n, start + ty * wl + tx, h] = walk_sum(
                            range(len(walk)), coefs,
                            rows[np.array(walk, np.int64)] if walk else
                            np.zeros((0, D), F32), plan.walks[l], G)
        start += hl * wl
    return grad, all_ids, all_starts


# --------------------------------------------------------------------------
# cases


def _case(kind, seed=0, shapes=((8, 8), (4, 4)), Q=24, P=4, N=2, H=2, D=16):
    rs = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    if kind == "clustered":  # a few texels of level 0 around each query
        ref = rs.rand(N, Q, 1, 1, 1, 2)
        loc = ref + rs.randn(N, Q, H, L, P, 2) * 1.5 / shapes[0][1]
    elif kind == "uniform":
        loc = rs.uniform(-0.1, 1.1, (N, Q, H, L, P, 2))
    elif kind == "one_cell":
        loc = np.full((N, Q, H, L, P, 2), 0.37)
    elif kind == "all_out":
        loc = rs.uniform(1.6, 3.0, (N, Q, H, L, P, 2))
    else:
        raise ValueError(kind)
    value = rs.randn(N, S, H, D).astype(F32)
    w = rs.rand(N, Q, H, L, P).astype(F32)
    dout = rs.randn(N, Q, H * D).astype(F32)
    return value, shapes, loc.astype(F32), w, dout


CASES = {
    "clustered": dict(kind="clustered"),
    "uniform": dict(kind="uniform"),
    "one_cell": dict(kind="one_cell", shapes=((16, 16),)),
    "all_corners_out": dict(kind="all_out"),
    "lp_9": dict(kind="uniform", shapes=((8, 8), (4, 4), (2, 2)), P=3),
    "long_walks": dict(kind="clustered", Q=72, P=8, shapes=((4, 4), (2, 2))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_value_grad_matches_autograd_and_pallas_v5(case):
    """The emulated fixed-order value gradient against autograd through the
    plain version and the Pallas v5 backward (interpret mode), fp32, within
    1e-6 of the scale; exact zeros where no corner is in bounds."""
    value, shapes, loc, w, dout = _case(**CASES[case])
    got, _, _ = emulate_value_grad(value.shape, shapes, loc, w, dout)
    plain = kmod.ms_deform_attn_plain_backward(t(value), shapes, t(loc), t(w),
                                               t(dout))[0].numpy()
    pallas = np.asarray(_ms_deform_attn_pallas_v5_bwd(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
        jnp.asarray(dout), tile_q=32, interpret=True)[0])
    if case == "all_corners_out":
        assert not got.any() and not plain.any()
        return
    for want in (plain, pallas):
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


@pytest.mark.parametrize("case", ["clustered", "uniform", "one_cell"])
def test_binning_is_a_stable_sort_by_cell(case):
    """Each binning CTA's ids equal a stable sort of its samples by cell
    (the samples with no cell left out), whatever the number of warps."""
    value, shapes, loc, w, dout = _case(**CASES[case])
    _, ids, starts = emulate_value_grad(value.shape, shapes, loc, w, dout)
    Q, P = loc.shape[1], loc.shape[4]
    for (n, h, l), got in ids.items():
        hl, wl = shapes[l]
        keys, _, _ = cell_keys(loc[n, :, h, l].reshape(Q * P, 2), hl, wl)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got, order[keys[order] >= 0])
        for warps in (1, 3, 32):
            again, s2 = bin_level(keys, (hl + 1) * (wl + 1), warps)
            np.testing.assert_array_equal(again, got)
            np.testing.assert_array_equal(s2, starts[n, h, l])


def test_one_cell_walk_is_linear():
    """Every sample in one cell: the four texels around it walk all of them
    once each, the rest none."""
    value, shapes, loc, w, dout = _case(**CASES["one_cell"])
    _, ids, starts = emulate_value_grad(value.shape, shapes, loc, w, dout)
    Q, P = loc.shape[1], loc.shape[4]
    for key in ids:
        counts = np.diff(starts[key])
        assert sorted(counts[counts > 0]) == [Q * P]


# --------------------------------------------------------------------------
# the pure functions


@pytest.mark.parametrize("D,dtype,want", [
    (64, BF16, "grouped"), (32, BF16, "grouped"), (128, BF16, "grouped"),
    (16, FP32, "grouped"), (64, FP32, "grouped"),
    (4, BF16, "channel"), (8, BF16, "channel"), (8, FP32, "channel"),
    (16, BF16, "channel"), (20, BF16, "channel"), (256, BF16, "channel"),
])
def test_forward_variant_by_width_and_dtype(D, dtype, want):
    """Kernel 1's body: the flagship's D = 64 / 32 take the grouped body, the
    tiny preset's D = 4 / 8 the per-channel one; the rule of kernel 3."""
    assert kmod.forward_variant(D, dtype) == want
    assert (want == "grouped") == (kmod.loc_weight_variant(D, dtype)
                                   == "grouped")


@pytest.mark.parametrize("shapes,Q,P,D,dtype,want", [
    # the flagship's UNet MMFS in training, 64 / 32 / 8 px (D = 64 bf16)
    (UNET, 4096, 8, 64, BF16,
     (5684, "shared", 12, "grouped", ("group", "warp", "warp", "warp"))),
    (UNET, 1024, 8, 64, BF16,
     (5684, "shared", 12, "grouped", ("group", "group", "warp", "warp"))),
    (UNET, 64, 8, 64, BF16,
     (5684, "shared", 12, "grouped", ("group",) * 4)),
    # the LLM's MMFS and the adapter's injector / extractor (D = 32)
    (LLM, 256, 8, 64, BF16,
     (1459, "shared", 32, "grouped", ("group", "group", "warp"))),
    (LLM, 256, 4, 32, BF16,
     (1459, "shared", 32, "grouped", ("group", "group", "warp"))),
    (((16, 16),), 1344, 4, 32, BF16,
     (289, "shared", 32, "grouped", ("warp",))),
    # the tiny preset (D = 8, fp32 and bf16): lanes along D
    (((8, 8), (4, 4), (2, 2), (1, 1)), 4, 2, 8, FP32,
     (119, "shared", 32, "lanes", ("warp",) * 4)),
    (((8, 8), (4, 4), (2, 2), (1, 1)), 4, 2, 8, BF16,
     (119, "shared", 32, "lanes", ("warp",) * 4)),
    # a level whose table does not fit four warps' rows: device memory
    (((128, 128),), 300, 4, 64, BF16,
     (16641, "global", 8, "grouped", ("group",))),
    (((96, 96),), 300, 4, 64, BF16,
     (9409, "shared", 5, "grouped", ("group",))),
])
def test_value_grad_plan(shapes, Q, P, D, dtype, want):
    plan = kmod.value_grad_plan(shapes, Q, len(shapes), P, D, dtype)
    assert tuple(plan) == want
    if plan.table == "shared":
        most = max((h + 1) * (w + 1) for h, w in shapes)
        assert (plan.bin_warps + 1) * most * 4 <= kmod.SHARED_BYTES


def test_value_grad_plan_refuses_ids_past_int32():
    with pytest.raises(ValueError, match="int32"):
        kmod.value_grad_plan(((8, 8),), 2 ** 28, 1, 8, 64, BF16)
    with pytest.raises(ValueError, match="levels"):
        kmod.value_grad_plan(((8, 8),), 4, 2, 2, 64, BF16)


def fast_div(d):
    """The binning's divisor (``fast_div`` of ``ms_deform_attn_bwd.cu``)."""
    s = 0
    while (1 << s) < d:
        s += 1
    return ((1 << 32) * ((1 << s) - d)) // d + 1, s


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 9, 12, 24, 32, 100, 1000])
def test_fast_div_divides(d):
    """q = (hi32(n * m) + n) >> s equals n // d over 0 <= n < 2^31, as
    32-bit unsigned arithmetic computes it."""
    m, s = fast_div(d)
    assert 0 < m < 2 ** 32
    rs = np.random.RandomState(d)
    ns = np.concatenate([np.arange(0, 5000), rs.randint(0, 2 ** 31, 5000),
                         [2 ** 31 - 1, 2 ** 31 - 2, d * 12345 - 1]])
    for n in ns.tolist():
        hi = (n * m) >> 32
        assert hi + n < 2 ** 32
        assert (hi + n) >> s == n // d


# --------------------------------------------------------------------------
# refusals before any launch


def _misaligned(x):
    """A contiguous copy of ``x`` that starts one element past a 16-byte
    boundary."""
    buf = torch.zeros(x.numel() + 16, dtype=x.dtype)
    start = next(i for i in range(1, 16)
                 if (buf.data_ptr() + i * x.element_size()) % 16)
    return buf[start:start + x.numel()].view(x.shape).copy_(x)


def _args(D, dtype=BF16):
    return [torch.zeros(1, 16, 2, D, dtype=dtype), ((4, 4),),
            torch.zeros(1, 3, 2, 1, 2, 2, dtype=dtype),
            torch.zeros(1, 3, 2, 1, 2, dtype=dtype),
            torch.zeros(1, 3, 2 * D, dtype=dtype)]


@pytest.mark.parametrize("kernel,D,dtype,i,match", [
    ("fwd", 64, BF16, 0, "16-byte"), ("fwd", 16, FP32, 0, "16-byte"),
    ("fwd", 20, BF16, 0, "CUDA"),    # the per-channel body: any alignment
    ("value", 64, BF16, 4, "16-byte"), ("value", 32, FP32, 4, "16-byte"),
    ("value", 20, BF16, 4, "CUDA"),  # lanes along D: any alignment of dOut
    ("value", 64, BF16, 2, "two elements"),
    ("value", 20, FP32, 2, "two elements"),
])
def test_misaligned_views_refused_before_any_launch(kernel, D, dtype, i,
                                                    match):
    """A view the chosen body loads as vectors, off its boundary, raises
    before the device check and counts nothing; elsewhere the call goes on
    to the device check."""
    fn = dict(fwd=kmod.ms_deform_attn_cuda,
              value=kmod.ms_deform_attn_bwd_value_cuda)[kernel]
    args = _args(D, dtype)
    if kernel == "fwd":
        args = args[:4]
    args[i] = _misaligned(args[i])
    before = fn.launches
    with pytest.raises(ValueError, match=match):
        fn(*args)
    assert fn.launches == before


# --------------------------------------------------------------------------
# the edge cases of the card


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_deform_edges_reach_every_body_and_plan():
    """`chip_smoke.py`'s `DEFORM_BWD_EDGES` give kernels 1, 2 and 3 the
    bodies and plans they list, and between them reach every one: both
    forward bodies, both value-gradient bodies and tables, both walks, the
    three dtype pairs, one cell, every corner out of bounds."""
    smoke = _smoke()
    seen = set()
    for name, (kw, want) in smoke.DEFORM_BWD_EDGES.items():
        D = kw.get("D", 64)
        dtype = getattr(torch, kw.get("dtype", "bfloat16"))
        shapes = kw.get("shapes", ((16, 16), (8, 8)))
        Q, P = kw.get("Q", 300), kw.get("P", 4)
        plan = kmod.value_grad_plan(shapes, Q, len(shapes), P, D, dtype)
        got = dict(fwd=kmod.forward_variant(D, dtype), table=plan.table,
                   value=plan.body, loc_weight=kmod.loc_weight_variant(
                       D, dtype))
        assert got == want, name
        seen |= {f"{k}={v}" for k, v in got.items()}
        seen |= {f"walk={w}" for w in plan.walks}
        seen.add(f"pair={kw.get('dtype', 'bfloat16')}/"
                 f"{kw.get('loc_dtype', kw.get('dtype', 'bfloat16'))}")
        seen |= {k for k in ("one_cell", "out") if kw.get(k)}
    assert seen >= {"fwd=grouped", "fwd=channel", "table=shared",
                    "table=global", "value=grouped", "value=lanes",
                    "walk=group", "walk=warp", "pair=bfloat16/bfloat16",
                    "pair=bfloat16/float32", "pair=float32/float32",
                    "one_cell", "out"}


def test_bench_unet_kernels_deform_on_the_cpu():
    """The benchmark's kernel 1 and kernel 2 rows on the CPU: the plain
    versions at the tiny sites, finite."""
    rows = bench.run("cpu", kernels=("deform_fwd", "deform_value"))
    assert {r["kernel"] for r in rows} == {"ms_deform_attn_fwd",
                                           "ms_deform_attn_bwd_value"}
    assert all(r["finite"] for r in rows)
