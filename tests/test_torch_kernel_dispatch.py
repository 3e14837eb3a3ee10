"""The Python half of the Hopper GEGLU and multi-image MMFS kernels, on the
CPU: each wrapper's choice of kernel variant by shape and dtype (a pure
function, mirrored by the checks in ``csrc/``), the tiled MMFS kernel's
query order and its grid's mapping of work onto output rows, the refusals
that come before any launch, and the benchmark module of the two kernels
at its CPU size.

The grid mapping is an emulation of ``csrc/ms_deform_attn_mi.cu``'s tiled
kernel (its choice of rounds, tile slot -> ``order[pos]`` -> output row):
each CTA's streams computed by the plain op on exactly the inputs they
read, and the assembled output held against the plain op (atol 1e-6: the
same sums) and the JAX op in interpret mode (1e-5, as in
tests/test_torch_ops.py).  The kernel itself is checked on the card
(`chip_smoke.py`, phase 7: the captured sites and `MI_EDGES`).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops.ms_deform_attn_pallas_mi import (
    mmfs_deform_factorized as j_mi,
)
from mm_interleaved_tpu_torch import bench_unet_kernels as bench
from mm_interleaved_tpu_torch.ops import geglu as tgeglu
from mm_interleaved_tpu_torch.ops import ms_deform_attn_mi as tmi

from _torch_parity import close, mi_inputs, t

BF16, FP32 = torch.bfloat16, torch.float32
LEVELS = ((64, 64), (32, 32), (16, 16), (8, 8))


@pytest.mark.parametrize("C,Fh,dtype,want", [
    (320, 1280, BF16, "wgmma_rows"),   # flagship, 64 px blocks
    (640, 2560, BF16, "wgmma_cols"),   # flagship, 32 px blocks
    (64, 256, BF16, "wgmma_rows"),
    (192, 768, BF16, "wgmma_rows"),
    (384, 1536, BF16, "wgmma_cols"),
    (512, 2048, BF16, "wgmma_cols"),
    (448, 1792, BF16, "cuda_core"),    # C % 128 != 0 above 320
    (576, 2304, BF16, "cuda_core"),
    (256, 1024, BF16, "wgmma_rows"),
    (320, 1312, BF16, "cuda_core"),    # F % 64 != 0
    (16, 64, BF16, "cuda_core"),       # the tiny preset
    (32, 128, BF16, "cuda_core"),
    (320, 1280, FP32, "cuda_core"),
    (640, 2560, FP32, "cuda_core"),
])
def test_geglu_variant_by_shape_and_dtype(C, Fh, dtype, want):
    assert tgeglu.geglu_variant(C, Fh, dtype) == want
    assert tgeglu.geglu_accepts(want, C, Fh, dtype)
    # no variant preferred over the chosen one takes the call
    for v in list(tgeglu.VARIANTS)[:list(tgeglu.VARIANTS).index(want)]:
        assert not tgeglu.geglu_accepts(v, C, Fh, dtype)


@pytest.mark.parametrize("D,dtype,want", [
    (64, BF16, "tiled"),   # the flagship: 8 lanes of 16 bytes
    (32, BF16, "tiled"),
    (8, BF16, "tiled"),    # the tiny preset: one lane
    (256, BF16, "tiled"),  # 32 lanes
    (20, BF16, "flat"),    # not a whole number of 16-byte lanes
    (24, BF16, "flat"),    # 3 lanes
    (264, BF16, "flat"),   # more than a warp
    (128, BF16, "tiled"),  # 16 lanes
    (64, FP32, "tiled"),   # 16 lanes
    (8, FP32, "tiled"),
    (6, FP32, "flat"),
    (256, FP32, "flat"),
])
def test_mi_variant_by_width_and_dtype(D, dtype, want):
    assert tmi.mi_variant(D, dtype) == want
    assert tmi.mi_accepts(want, D, dtype)


def test_unknown_variants_raise():
    with pytest.raises(ValueError, match="unknown variant"):
        tgeglu.geglu_accepts("wgmma", 320, 1280, BF16)
    with pytest.raises(ValueError, match="unknown variant"):
        tmi.mi_accepts("gather", 64, BF16)


@pytest.mark.parametrize("Lq", [4096, 1024, 256, 1600])
def test_query_tile_order_takes_square_blocks(Lq):
    """A permutation whose every run of 64 entries is one 8 x 8 block of
    the row-major query grid, blocks in row-major order; its inverse
    restores the queries."""
    order = tmi.query_tile_order(Lq)
    W = int(round(Lq ** 0.5))
    assert torch.equal(torch.sort(order).values, torch.arange(Lq))
    blocks = order.reshape(-1, 64)
    ys, xs = blocks // W, blocks % W
    assert torch.equal(ys.amax(1) - ys.amin(1), torch.full((Lq // 64,), 7))
    assert torch.equal(xs.amax(1) - xs.amin(1), torch.full((Lq // 64,), 7))
    first = blocks[:, 0]
    assert torch.equal(first, torch.sort(first).values)
    inv = torch.argsort(order)
    assert torch.equal(order[inv], torch.arange(Lq))


@pytest.mark.parametrize("Lq", [64, 70, 1000, 144])
def test_query_tile_order_is_the_identity_off_the_grid(Lq):
    """8 px (one block), non-square counts and sides that are no multiple
    of 8 keep the queries in their order."""
    assert torch.equal(tmi.query_tile_order(Lq), torch.arange(Lq))


SMS = 132  # the H100's SMs, which the kernel's choice of rounds reads


def tiled_grid(Lq, Bv, B, lanes, sms=SMS):
    """``csrc/ms_deform_attn_mi.cu``'s tiled grid, emulated: for each CTA
    (tile, bv) — every head's CTA takes the same rows — the (b, q) rows
    its streams compute, in stream order.  Rounds as
    ``launch_tiled_lanes`` picks them (the most, up to 4, that give every
    SM two CTAs at H = 1), a stream's slot, position, query and row as
    ``mi_tiled_kernel`` maps them."""
    order = tmi.query_tile_order(Lq)
    R = B // Bv
    per_round = 8 * (32 // lanes)

    def ctas(rr):
        tq = per_round * rr // R
        return 0 if tq < 1 else -(-Lq // tq) * Bv

    rounds = 4
    while rounds > 1 and ctas(rounds) < 2 * sms:
        rounds //= 2
    while per_round * rounds // R < 1 and rounds < 64:
        rounds *= 2
    TQ = per_round * rounds // R
    grid = {}
    for tile in range(-(-Lq // TQ)):
        for bv in range(Bv):
            rows = []
            for s in range(per_round * rounds):  # (r * 8 + warp) * SW + ks
                slot, pos = s // R, tile * TQ + s // R
                if slot < TQ and pos < Lq:
                    rows.append(((s % R) * Bv + bv, int(order[pos])))
            grid[tile, bv] = rows
    return grid, TQ


@pytest.mark.parametrize("Lq,Bv,B,lanes", [
    (4096, 4, 8, 8),   # the flagship at 64 px: one 8 x 8 block a CTA
    (1024, 4, 8, 8),   # 32 px
    (64, 4, 8, 8),     # 8 px: the identity order
    (1000, 4, 8, 8),   # ragged: the last tile runs past Lq
    (1024, 4, 4, 8),   # no CFG sharing
    (256, 2, 4, 1),    # one lane a stream (bf16 at D = 8)
])
def test_tiled_grid_covers_every_row_once(Lq, Bv, B, lanes):
    """Every (b, q) row is computed by exactly one stream; each CTA takes
    the same queries from every query row that reads its image row (both
    CFG halves), and, on the UNet's square grids, a whole 8 x 8 block."""
    grid, TQ = tiled_grid(Lq, Bv, B, lanes)
    seen = [row for rows in grid.values() for row in rows]
    assert len(seen) == len(set(seen)) == B * Lq
    W = int(round(Lq ** 0.5))
    for (tile, bv), rows in grid.items():
        qs = {}
        for b, q in rows:
            assert b % Bv == bv
            qs.setdefault(b, []).append(q)
        assert len(qs) == B // Bv
        assert all(v == next(iter(qs.values())) for v in qs.values())
        if Lq >= 256 and W * W == Lq and TQ == 64:
            q = torch.tensor(next(iter(qs.values())))
            assert int((q // W).max() - (q // W).min()) == 7
            assert int((q % W).max() - (q % W).min()) == 7


def _emulated_tiled(args):
    """The output assembled as the tiled kernel's grid writes it: each
    CTA's streams computed by the plain op from the inputs they read (image
    row bv, their own query rows), each written to its output row; rows
    nobody writes stay NaN."""
    value, delta, shapes, ref, off_q, wq, inv_base = args
    Bv, D = value.shape[0], value.shape[-1]
    B, Lq = ref.shape[:2]
    grid, _ = tiled_grid(Lq, Bv, B, D * value.element_size() // 16)
    out = torch.full((B, Lq, value.shape[3] * D), float("nan"))
    for (_, bv), rows in grid.items():
        b, q = (torch.tensor(c) for c in zip(*rows))
        part = tmi.ms_deform_attn_mi_plain(
            value[bv:bv + 1], delta[bv:bv + 1], shapes, ref[b, q][None],
            off_q[b, q][None], wq[b, q][None], inv_base)
        out[b, q] = part[0]
    return out


@pytest.mark.parametrize("Bv,B", [(2, 2), (2, 4)])
def test_tiled_order_against_plain_and_jax(Bv, B):
    """The output as the tiled kernel's grid assembles it (query tiles in
    `query_tile_order`, both CFG halves in one CTA), at a 16 x 16 query
    grid and at a ragged 70 queries, against the plain op as called and (Bv
    = B, the 16 x 16 grid) against the JAX factorised kernel in interpret
    mode, on test_mi_plain_matches_factorized_kernel_interpret's inputs."""
    shapes = ((16, 16), (8, 8))
    for Lq in (256, 70):
        value, off_img, wi, ref, off_q, wq = mi_inputs(shapes, Lq, 2, Bv, B,
                                                       3)
        delta = tmi.build_delta(t(off_img), t(wi), shapes, 1.0 / 16)
        args = (t(value), delta, shapes, t(ref), t(off_q), t(wq), 1.0 / 16)
        got = _emulated_tiled(args)
        close(got, tmi.ms_deform_attn_mi_plain(*args), 0, 1e-6)
        if Bv == B and Lq == 256:
            jwant = j_mi(jnp.asarray(value), shapes, jnp.asarray(ref),
                         jnp.asarray(off_q), jnp.asarray(off_img),
                         jnp.asarray(wq), jnp.asarray(wi), inv_base=1.0 / 16,
                         interpret=True)
            close(got, jwant, 0, 1e-5)


def _geglu_args(C, dtype=BF16):
    return (torch.zeros(5, C, dtype=dtype),
            torch.zeros(8 * C, C, dtype=dtype),
            torch.zeros(8 * C, dtype=dtype),
            torch.zeros(C, 4 * C, dtype=dtype),
            torch.zeros(C, dtype=dtype))


def _mi_args(D, L=1, dtype=BF16):
    shapes = ((4, 4),) * L
    return (torch.zeros(1, 1, 16 * L, 2, D, dtype=dtype),
            torch.zeros(1, 2, 1, L * 3), shapes, torch.zeros(2, 5, 2),
            torch.zeros(2, 5, 2, 1, 2),
            torch.zeros(2, 5, 2, L, 1, dtype=dtype), 0.25)


def _misaligned(x):
    """A contiguous copy of ``x`` that starts off a 16-byte boundary."""
    buf = torch.zeros(x.numel() + 8, dtype=x.dtype)
    start = next(i for i in range(1, 8)
                 if (buf.data_ptr() + i * x.element_size()) % 16)
    return buf[start:start + x.numel()].view(x.shape).copy_(x)


def test_wrappers_refuse_before_any_launch():
    """Shapes a kernel does not take raise in the wrapper before the
    device check (here on CPU tensors), CPU tensors raise at the device
    check, and nothing is counted."""
    g, m = tgeglu.geglu_cuda, tmi.ms_deform_attn_mi_cuda
    cases = [
        (g, _geglu_args(704), "width 704"),
        (g, _geglu_args(320), "CUDA"),
        (g, _geglu_args(640), "CUDA"),
        (g, _geglu_args(448), "CUDA"),
        (g, _geglu_args(16, FP32), "CUDA"),
        (m, _mi_args(8, L=9), "9 levels"),
        (m, _mi_args(64), "CUDA"),
        (m, _mi_args(20), "CUDA"),
    ]
    for kernel, args, match in cases:
        before = kernel.launches
        with pytest.raises(ValueError, match=match):
            kernel(*args)
        assert kernel.launches == before


@pytest.mark.parametrize("kernel,args,i,match", [
    # the Hopper GEGLU loads x, w1 and w2 by TMA
    ("geglu", _geglu_args(320), 0, "16-byte"),
    ("geglu", _geglu_args(320), 1, "16-byte"),
    ("geglu", _geglu_args(320), 3, "16-byte"),
    ("geglu", _geglu_args(640), 0, "16-byte"),
    # the CUDA-core body takes any alignment: the device check comes next
    ("geglu", _geglu_args(32), 0, "CUDA"),
    ("geglu", _geglu_args(320, FP32), 0, "CUDA"),
    # the tiled MMFS kernel's 16-byte loads; the flat one takes any
    ("mi", _mi_args(64), 0, "16-byte"),
    ("mi", _mi_args(20), 0, "CUDA"),
])
def test_misaligned_views_refused_at_the_hopper_widths(kernel, args, i,
                                                       match):
    """A contiguous view off a 16-byte boundary raises before any launch
    where the chosen variant needs the alignment (no slower variant is
    taken instead), and passes on to the device check where it does
    not."""
    kernel = dict(geglu=tgeglu.geglu_cuda,
                  mi=tmi.ms_deform_attn_mi_cuda)[kernel]
    args = list(args)
    args[i] = _misaligned(args[i])
    assert args[i].is_contiguous() and args[i].data_ptr() % 16
    before = kernel.launches
    with pytest.raises(ValueError, match=match):
        kernel(*args)
    assert kernel.launches == before


def test_bench_unet_kernels_cpu_and_offset_spread():
    """The benchmark's CPU run (plain versions, tiny size) is finite, and
    the offset spread reads texels of each level: zero where every offset
    is zero, 2 + 1 texels at level 0 (and 1 + 0.5 at level 1) for a query
    offset of 2 level-0 texels and an image offset of 1."""
    rows = bench.run("cpu")
    assert [r["kernel"] for r in rows] == ["geglu_fwd",
                                           "ms_deform_attn_mi_fwd"]
    assert all(r["finite"] for r in rows)
    shapes = ((16, 16), (8, 8))
    args = list(bench.mi_inputs(256, np.random.RandomState(0), "cpu",
                                shapes=shapes, Bv=2, B=4, H=2, D=8, P=2,
                                live=(0, 1), inv_base=1 / 16))
    args[4] = torch.zeros_like(args[4])
    args[1] = tmi.build_delta(torch.zeros(2, 1, 2, 2, 2),
                              torch.ones(2, 1, 2, 2, 2), shapes, 1 / 16)
    spread = bench.offset_spread(args)
    assert all(v == dict(p50=0.0, p90=0.0, max=0.0) for v in spread.values())
    args[4] = torch.full_like(args[4], 2.0)
    args[1] = tmi.build_delta(torch.ones(2, 1, 2, 2, 2),
                              torch.ones(2, 1, 2, 2, 2), shapes, 1 / 16)
    spread = bench.offset_spread(args)
    assert spread["level0_16x16"]["max"] == pytest.approx(3.0)
    assert spread["level1_8x8"]["p50"] == pytest.approx(1.5)
