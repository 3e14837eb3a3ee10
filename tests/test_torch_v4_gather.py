"""The v4 gathers' arithmetic (kernels 8a and 8c, `csrc/ms_deform_attn_v4.cu`
and the location/weight kernel of `csrc/ms_deform_attn_v4_bwd.cu`) in plain
torch, held against the dense plain versions of `ops/ms_deform_attn_v4.py`.

The kernels enumerate each (query, level)'s 4P corners, corner i = 4p + c
of point p in row-major order (x0, y0), (x1, y0), (x0, y1), (x1, y1), with
x0 = floor(xs): the texel (none outside the grid) and the term
hat(x - xs) * (hat(y - ys) * aw).  The forward merges the corners by texel:
the first corner of a texel leads and sums the texel's terms in corner
order, rounds the sum to the value's dtype and takes A * V[texel].  The
location/weight gradient takes, per sample, the four corners' dot products
dA_c = g . V_c and blends them with the corners' hats and slopes.

The value gradient (8b, the value kernel of `csrc/ms_deform_attn_v4_bwd.cu`)
is texel-major: each sample's four corner keys at slot 4 (q P + p) + c
(the corner's texel, -1 outside the grid), a stable sort of the entries by
texel, then per texel the first entry of each query sums the query's terms
one after another in point order, rounds the sum to the value's dtype,
drops it if it is 0, and adds A times the query's dOut row (fp32).

Checked: every non-zero entry of the dense fp32 A of a (query, level) is
a merged entry with the same bits, before rounding, and every merged entry
is the dense one; the gather forward and the gather d_loc / d_w within
1e-6 of the dense plain versions' scale in fp32 (the same terms summed in
another order); the merged, rounded A equal to the dense rounded A bit for
bit in bf16; 8b's texel-major walk lists each (query, texel) entry of the
dense A once, bit for bit before and after rounding, and its dV is within
1e-6 of the dense plain version's scale in fp32 (within one bf16 ulp of it
in bf16).  Cases: locations over [-0.2, 1.2] (corners outside the
grid), coordinates on whole texels (the hat's kinks, where the far corner
sits at |t| = 1 exactly), every point of a query on one texel, P = 1, 8, 9
and 64, non-square levels, Q off any tile (the kernels take 32 queries a
CTA).  No JAX: the dense plain versions are held to the JAX kernels in
tests/test_torch_v4_backward.py and tests/test_torch_deform_baselines.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mm_interleaved_tpu_torch import bench_v4_kernels as bench
from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk
from mm_interleaved_tpu_torch.ops import ms_deform_attn_v4 as v4

_DX = torch.tensor([0.0, 1.0, 0.0, 1.0])
_DY = torch.tensor([0.0, 0.0, 1.0, 1.0])

# name: (level shapes, Q, P, location draw)
CASES = {
    "out_of_grid": (((12, 16), (6, 8), (3, 4)), 37, 4, "wide"),
    "kinks": (((16, 16), (8, 8)), 33, 8, "whole"),
    "one_texel": (((8, 8),), 35, 8, "one"),
    "p1": (((7, 9), (4, 5)), 29, 1, "wide"),
    "p9": (((16, 12), (8, 6)), 41, 9, "wide"),
    "p64": (((8, 8), (4, 4)), 7, 64, "wide"),
    "p64_whole": (((8, 16),), 5, 64, "whole"),
}


def _inputs(shapes, Q, P, draw, B=2, H=2, D=8, seed=0):
    """``(value, shapes, loc, w, grad_out)`` in fp32: locations over
    [-0.2, 1.2] (``wide``), snapped to whole texels of each level
    (``whole``: xs = loc * w - 0.5 a whole number), or all of a query's
    points at one place within a texel of level 0 (``one``)."""
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2))
    if draw == "whole":
        for lid, (h, w) in enumerate(shapes):
            for axis, n in ((0, w), (1, h)):
                k = np.floor(loc[:, :, :, lid, :, axis] * n)
                loc[:, :, :, lid, :, axis] = (k + 0.5) / n
    elif draw == "one":
        loc[:] = loc[:, :, :, :, :1]
        loc = np.clip(loc, 0.05, 0.95)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (t(rng.randn(B, S, H, D) * 0.1), shapes, t(loc),
            t(rng.rand(B, Q, H, L, P)), t(rng.randn(B, Q, H * D)))


def corners(xs, ys, aw, h, w):
    """Each sample's four corners: texel ids ``[..., P, 4]`` (-1 outside the
    grid) and terms hat(x - xs) * (hat(y - ys) * aw), as the kernels round
    them; ``xs, ys, aw [..., P]`` in texel coordinates."""
    cx = torch.floor(xs)[..., None] + _DX
    cy = torch.floor(ys)[..., None] + _DY
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    wy = v4._hat(cy - ys[..., None]) * aw[..., None]
    term = v4._hat(cx - xs[..., None]) * wy
    texel = torch.where(inside, cy * w + cx, torch.full_like(cx, -1.0))
    return texel.long(), torch.where(inside, term, torch.zeros_like(term))


def merge(texel, term):
    """The forward's merge of ``[M, P, 4]`` corners a row (M rows, one per
    query-head): ``(lead, A)``, ``[M, 4P]`` each, the first corner of each
    texel leading and its A the texel's terms summed in corner order (0
    where not leading)."""
    k = texel.flatten(1)
    t = term.flatten(1)
    n = k.shape[1]
    same = (k[:, :, None] == k[:, None, :]) & (k[:, :, None] >= 0)
    earlier = torch.ones(n, n, dtype=torch.bool).tril(-1)
    lead = (k >= 0) & ~(same & earlier).any(-1)
    a = torch.zeros_like(t)
    for j in range(n):  # corner order, which is the order of the points
        take = same[:, :, j] & (torch.arange(n) <= j)
        a = torch.where(take, a + t[:, j:j + 1], a)
    return lead, torch.where(lead, a, torch.zeros_like(a))


def _level(args, lid):
    """Level ``lid``'s samples ``xs, ys, aw [BH, Q, P]`` and its values."""
    value, shapes, loc, w = args[:4]
    _, flat_loc, flat_w = v4._flat(value, loc, w)
    h, w_ = shapes[lid]
    return v4._samples(flat_loc, flat_w, lid, h, w_, slice(None)), (h, w_)


def gather_forward(value, shapes, loc, w):
    """8a's arithmetic: the merged corners' A, rounded to the value's dtype,
    against the gathered value rows, fp32 sums; ``[N, Q, H*D]``."""
    N, S, H, D = value.shape
    Q = loc.shape[1]
    val = v4._flat(value, loc, w)[0].float()
    acc = torch.zeros(N * H, Q, D)
    start = 0
    for lid in range(len(shapes)):
        (xs, ys, aw), (h, w_) = _level((value, shapes, loc, w), lid)
        texel, term = corners(xs, ys, aw, h, w_)
        lead, a = merge(texel.flatten(0, 1), term.flatten(0, 1))
        a = a.to(value.dtype).float() * lead
        rows = val[:, start:start + h * w_]
        idx = texel.flatten(2).clamp_min(0)  # [BH, Q, 4P]
        got = torch.gather(rows[:, None].expand(-1, Q, -1, -1), 2,
                           idx[..., None].expand(-1, -1, -1, D))
        acc += (a.view(N * H, Q, -1, 1) * got).sum(2)
        start += h * w_
    out = acc.view(N, H, Q, D).permute(0, 2, 1, 3).reshape(N, Q, H * D)
    return out.to(value.dtype)


def gather_loc_weight(value, shapes, loc, w, grad_out):
    """8c's arithmetic: per sample the four corners' dA_c = g . V_c and the
    blend with their hats and slopes in row-major order; ``(d_loc, d_w)``
    in fp32."""
    N, S, H, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    val = v4._flat(value, loc, w)[0].float()
    g = v4._grad_rows(grad_out, value)  # [BH, Q, D]
    d_loc = torch.zeros(N * H, Q, L, P, 2)
    d_w = torch.zeros(N * H, Q, L, P)
    start = 0
    for lid in range(L):
        (xs, ys, aw), (h, w_) = _level((value, shapes, loc, w), lid)
        texel, _ = corners(xs, ys, aw, h, w_)
        rows = val[:, start:start + h * w_]
        idx = texel.flatten(2).clamp_min(0)
        vc = torch.gather(rows[:, None].expand(-1, Q, -1, -1), 2,
                          idx[..., None].expand(-1, -1, -1, D))
        dA = (vc * g[:, :, None]).sum(-1).view(N * H, Q, P, 4)
        dA = dA * (texel >= 0)
        tx = torch.floor(xs)[..., None] + _DX - xs[..., None]
        ty = torch.floor(ys)[..., None] + _DY - ys[..., None]
        wx, wy = v4._hat(tx), v4._hat(ty)
        sx, sy = v4._sign_on_support(tx), v4._sign_on_support(ty)
        d_w[:, :, lid] = (wx * wy * dA).sum(-1)
        d_loc[:, :, lid, :, 0] = aw * (sx * wy * dA).sum(-1) * w_
        d_loc[:, :, lid, :, 1] = aw * (wx * sy * dA).sum(-1) * h
        start += h * w_
    d_loc = d_loc.view(N, H, Q, L, P, 2).permute(0, 2, 1, 3, 4, 5)
    d_w = d_w.view(N, H, Q, L, P).permute(0, 2, 1, 3, 4)
    return d_loc.contiguous(), d_w.contiguous()


def texel_walk(texel, term, P):
    """8b's walk of one level: ``texel`` / ``term`` ``[M, Q, P, 4]`` (M
    rows, one per (n, h)), the entries at slot 4 (q P + p) + c.  The
    entries sorted stably by texel (``bin_samples``: ties keep entry order,
    so by query and within a query by point), then each run of one query
    within a texel summed one term after another from 0 in fp32, the first
    entry leading.  Returns ``(row, q, texel, A)`` of every (query, texel)
    pair, A before rounding."""
    M = texel.shape[0]
    key = texel.reshape(M, -1)
    val = term.reshape(M, -1)
    n = key.shape[1]
    big = torch.iinfo(torch.int64).max
    order = torch.sort(torch.where(key >= 0, key, big), dim=1,
                       stable=True).indices
    k = torch.gather(key, 1, order)
    t = torch.gather(val, 1, order)
    q = order // (4 * P)
    live = k >= 0
    # a pair starts where the texel or the query changes
    start = torch.ones_like(live)
    start[:, 1:] = (k[:, 1:] != k[:, :-1]) | (q[:, 1:] != q[:, :-1])
    start &= live
    seg = torch.cumsum(start.flatten().long(), 0).view(M, n) - 1
    idx = torch.arange(n).expand(M, n)
    pos = idx - torch.cummax(torch.where(start, idx, torch.zeros_like(idx)),
                             dim=1).values
    sums = torch.zeros(int(start.sum()))
    for j in range(int(pos[live].max()) + 1 if bool(live.any()) else 0):
        at = live & (pos == j)  # one entry of each pair a step: in order
        sums[seg[at]] = sums[seg[at]] + t[at]
    rows = torch.arange(M)[:, None].expand(M, n)
    return rows[start], q[start], k[start], sums


def gather_bwd_value(value, shapes, loc, w, grad_out):
    """8b's arithmetic: the walk's (query, texel) sums rounded to the
    value's dtype (zeros dropped), times the queries' dOut rows, summed per
    texel in fp32; ``[N, S, H, D]`` in the value's dtype."""
    N, S, H, D = value.shape
    P = loc.shape[4]
    g = v4._grad_rows(grad_out, value)  # [BH, Q, D]
    dv = torch.zeros(N * H, S, D)
    start = 0
    for lid in range(len(shapes)):
        (xs, ys, aw), (h, w_) = _level((value, shapes, loc, w), lid)
        texel, term = corners(xs, ys, aw, h, w_)
        row, q, k, a = texel_walk(texel, term, P)
        a = a.to(value.dtype).float()
        keep = a != 0
        row, q, k, a = row[keep], q[keep], k[keep], a[keep]
        dv.index_put_((row, start + k), a[:, None] * g[row, q],
                      accumulate=True)
        start += h * w_
    dv = dv.view(N, H, S, D).permute(0, 2, 1, 3)
    return dv.to(value.dtype).contiguous()


def _assert_rel(got, want, rel):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("case", CASES)
def test_merged_corners_are_the_dense_matrix_bit_for_bit(case):
    """Scattered back to the level's texels, the merged entries equal the
    dense fp32 A (zeros included), so no non-zero entry is missed or
    altered before rounding; rounded to bf16 they equal the dense A rounded
    (the matrix 8a and the plain version multiply)."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw)
    for lid in range(len(shapes)):
        (xs, ys, aw), (h, w) = _level(args, lid)
        dense = v4._bilinear(xs, ys, aw, h, w)
        texel, term = corners(xs, ys, aw, h, w)
        lead, a = merge(texel.flatten(0, 1), term.flatten(0, 1))
        lead, a = lead.view(*xs.shape[:2], -1), a.view(*xs.shape[:2], -1)
        k = texel.flatten(2)
        got = torch.zeros_like(dense)
        got.scatter_add_(2, k.clamp_min(0), a)  # a is 0 off the leaders
        assert bool((got == dense).all()), case
        assert torch.equal(got.bfloat16(), dense.bfloat16()), case
        # every texel a corner touches has one leading corner, in the grid
        leaders = torch.zeros(dense.shape, dtype=torch.long)
        leaders.scatter_add_(2, k.clamp_min(0), lead.long())
        touched = torch.zeros(dense.shape, dtype=torch.long)
        touched.scatter_add_(2, k.clamp_min(0), (k >= 0).long())
        assert torch.equal(leaders, (touched > 0).long()), case
        assert bool((k[lead] >= 0).all())


@pytest.mark.parametrize("case", CASES)
def test_gather_forward_matches_dense_plain(case):
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw, seed=1)
    want = v4.ms_deform_attn_v4_plain(*args[:4])
    got = gather_forward(*args[:4])
    assert got.shape == want.shape
    _assert_rel(got, want, 1e-6)


@pytest.mark.parametrize("case", ["out_of_grid", "one_texel", "p9"])
def test_gather_forward_rounds_a_as_the_dense_plain_in_bf16(case):
    """bf16 values: A rounded after the merge, so the gather and the dense
    plain version multiply the same matrix; only the order of the fp32
    sums differs (within one bf16 ulp of the scale)."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw, seed=2)
    args = (args[0].bfloat16(),) + args[1:]
    want = v4.ms_deform_attn_v4_plain(*args[:4])
    got = gather_forward(*args[:4])
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, 2.0 ** -8)


@pytest.mark.parametrize("case", CASES)
def test_gather_loc_weight_matches_dense_plain(case):
    """The four corners' dot products and hats stand for the dense walk over
    every texel, kinks included: at a whole texel the near corner's slope
    is 0 (v4's sign(0) = 0) and the far corner's hat and slope are 0."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw, seed=3)
    want = v4.ms_deform_attn_v4_plain_bwd_loc_weight(*args)
    got = gather_loc_weight(*args)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _assert_rel(g, r, 1e-6)
    if draw == "whole":  # every slope 0: the location gradient is exactly 0
        assert not bool(got[0].any()) and not bool(want[0].any())


@pytest.mark.parametrize("case", CASES)
def test_texel_walk_lists_the_dense_matrix_bit_for_bit(case):
    """Binned by texel and merged a query at a time, the corners give every
    (query, texel) entry of the dense fp32 A once, with its bits (zeros
    included), and so the dense A rounded in bf16: the matrix 8b
    transposes is the one 8a and the plain version multiply."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw)
    for lid in range(len(shapes)):
        (xs, ys, aw), (h, w) = _level(args, lid)
        dense = v4._bilinear(xs, ys, aw, h, w)
        texel, term = corners(xs, ys, aw, h, w)
        row, q, k, a = texel_walk(texel, term, P)
        pairs = set(zip(row.tolist(), q.tolist(), k.tolist()))
        assert len(pairs) == len(row), case  # each pair listed once
        got = torch.zeros_like(dense)
        got.index_put_((row, q, k), a)
        assert bool((got == dense).all()), case
        assert torch.equal(got.bfloat16(), dense.bfloat16()), case
        # and every texel a query's corners touch is listed for it
        touched = torch.zeros(dense.shape, dtype=torch.bool)
        flat = texel.flatten(2)
        rr = torch.arange(flat.shape[0])[:, None, None].expand_as(flat)
        qq = torch.arange(flat.shape[1])[None, :, None].expand_as(flat)
        inside = flat >= 0
        touched[rr[inside], qq[inside], flat[inside]] = True
        assert len(pairs) == int(touched.sum()), case


@pytest.mark.parametrize("case", CASES)
def test_gather_bwd_value_matches_dense_plain(case):
    """fp32: the texel-major sums of the same products as the dense A^T g,
    in another order."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw, seed=4)
    want = v4.ms_deform_attn_v4_plain_bwd_value(*args)
    got = gather_bwd_value(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    _assert_rel(got, want, 1e-6)


@pytest.mark.parametrize("case", ["out_of_grid", "kinks", "one_texel", "p9"])
def test_gather_bwd_value_rounds_a_as_the_dense_plain_in_bf16(case):
    """bf16 values and dOut: A rounded after the point sum in both, so only
    the order of the fp32 sums over queries differs (within one bf16 ulp
    of the scale)."""
    shapes, Q, P, draw = CASES[case]
    args = _inputs(shapes, Q, P, draw, seed=5)
    args = (args[0].bfloat16(),) + args[1:4] + (args[4].bfloat16(),)
    want = v4.ms_deform_attn_v4_plain_bwd_value(*args)
    got = gather_bwd_value(*args)
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, 2.0 ** -8)


BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shapes,Q,P,D,dtype,want", [
    # the v5 benchmark's unet and prefill: the texel table of the 64 x 64
    # level takes 13 warps' rows in shared memory
    (((64, 64), (32, 32), (16, 16), (8, 8)), 4096, 8, 64, BF16,
     (5440, "shared", 13, "grouped", ("group", "warp", "warp", "warp"))),
    (((32, 32), (16, 16), (8, 8)), 512, 8, 64, BF16,
     (1344, "shared", 32, "grouped", ("group", "warp", "warp"))),
    # a level whose table does not fit four warps' rows: device memory
    (((128, 128),), 300, 4, 64, BF16,
     (16384, "global", 8, "grouped", ("group",))),
    (((96, 96),), 300, 4, 64, BF16,
     (9216, "shared", 5, "grouped", ("group",))),
    # rows of whole 16-byte vectors, 2 to 32 of them, and rows that are not
    (((16, 16),), 300, 4, 16, BF16, (256, "shared", 32, "grouped",
                                     ("group",))),
    (((16, 16),), 300, 4, 128, FP32, (256, "shared", 32, "grouped",
                                      ("group",))),
    (((16, 16),), 300, 4, 20, FP32, (256, "shared", 32, "grouped",
                                     ("group",))),
    (((16, 16), (4, 4)), 300, 4, 18, FP32, (272, "shared", 32, "lanes",
                                            ("warp", "warp"))),
])
def test_value_grad_plan(shapes, Q, P, D, dtype, want):
    """8b's plan: h * w texel bins a level, kernel 2's table and walk
    rules on them, "lanes" where a row is not whole 16-byte vectors."""
    plan = v4.value_grad_plan(shapes, Q, len(shapes), P, D, dtype)
    assert tuple(plan) == want
    assert plan.cells == sum(h * w for h, w in shapes)
    if plan.table == "shared":
        most = max(h * w for h, w in shapes)
        assert (plan.bin_warps + 1) * most * 4 <= dk.SHARED_BYTES


def test_value_grad_plan_refuses_ids_past_int32():
    """Four entries a sample: 8b refuses an (n, h) of 2^31 entry ids that
    kernel 2, an entry a sample, still takes."""
    with pytest.raises(ValueError, match="int32"):
        v4.value_grad_plan(((8, 8),), 2 ** 27, 1, 4, 64, BF16)
    v4.value_grad_plan(((8, 8),), 2 ** 27 - 1, 1, 4, 64, BF16)
    dk.value_grad_plan(((8, 8),), 2 ** 27, 1, 4, 64, BF16)
    with pytest.raises(ValueError, match="levels"):
        v4.value_grad_plan(((8, 8),), 4, 2, 2, 64, BF16)


def _misaligned(x):
    buf = torch.zeros(x.numel() + 16, dtype=x.dtype)
    start = next(i for i in range(1, 16)
                 if (buf.data_ptr() + i * x.element_size()) % 16)
    return buf[start:start + x.numel()].view(x.shape).copy_(x)


@pytest.mark.parametrize("D,dtype,match", [
    (64, BF16, "16-byte"), (16, BF16, "16-byte"), (20, FP32, "16-byte"),
    (18, FP32, "CUDA"),  # lanes along D: any alignment of dOut
])
def test_value_grad_refuses_misaligned_grad_out_before_any_launch(
        D, dtype, match):
    """8b's grouped body reads dOut rows as 16-byte vectors: a grad_out off
    a 16-byte boundary raises before the device check and counts
    nothing."""
    args = (torch.zeros(1, 16, 2, D, dtype=dtype), ((4, 4),),
            torch.zeros(1, 3, 2, 1, 2, 2), torch.zeros(1, 3, 2, 1, 2),
            _misaligned(torch.zeros(1, 3, 2 * D, dtype=dtype)))
    kernel = v4.ms_deform_attn_v4_bwd_value_cuda
    before = kernel.launches
    with pytest.raises(ValueError, match=match):
        kernel(*args)
    assert kernel.launches == before


def test_cases_cover_the_edges():
    """The draws reach what they are named for: corners outside the grid,
    whole-texel coordinates, one texel a query."""
    shapes, Q, P, draw = CASES["out_of_grid"]
    (xs, ys, aw), (h, w) = _level(_inputs(shapes, Q, P, draw), 0)
    texel, _ = corners(xs, ys, aw, h, w)
    assert bool((texel < 0).any()) and bool((texel >= 0).any())
    for case in ("kinks", "p64_whole"):
        shapes, Q, P, draw = CASES[case]
        args = _inputs(shapes, Q, P, draw)
        for lid in range(len(shapes)):
            (xs, ys, _), _ = _level(args, lid)
            assert bool((xs == torch.floor(xs)).all())
            assert bool((ys == torch.floor(ys)).all())
    shapes, Q, P, draw = CASES["one_texel"]
    (xs, ys, aw), (h, w) = _level(_inputs(shapes, Q, P, draw), 0)
    texel, _ = corners(xs, ys, aw, h, w)
    assert bool((texel == texel[:, :, :1]).all())


def _gather_body(D, dtype, misaligned):
    """The body the gathers take (``rows_in_vectors`` and ``row_lanes`` of
    ``csrc/ms_deform_attn_common.cuh``): the lanes a row where it is whole
    16-byte vectors on a 16-byte boundary, else single elements."""
    nbytes = D * torch.finfo(dtype).bits // 8
    if misaligned or nbytes % 16:
        return "single"
    lanes = 2
    while lanes < nbytes // 16:
        lanes *= 2
    return f"{lanes}_lanes"


def test_smoke_v4_edges_reach_every_body():
    """`chip_smoke.py`'s `V4_EDGES` reach every body of the three gathers
    in each dtype (2-16 lanes a row in bf16, 4-32 in fp32, single elements),
    P = 1, 8, 9 and 64, whole-texel coordinates, one spot a query, bf16
    locations, and a non-square level; for 8b both walks, the texel table
    in shared and in device memory, and its "lanes" body."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = set()
    for kw in smoke.V4_EDGES.values():
        dtype = kw.get("dtype", "bfloat16")
        body = _gather_body(kw.get("D", 64), getattr(torch, dtype),
                            kw.get("misaligned", False))
        seen |= {f"{dtype}/{body}", f"P={kw.get('P', 4)}",
                 f"draw={kw.get('draw', 'wide')}",
                 f"loc={kw.get('loc_dtype', 'float32')}"}
        if any(h != w for h, w in kw.get("shapes", ())):
            seen.add("non-square")
        shapes = kw.get("shapes", ((16, 16), (8, 8), (4, 4)))
        plan = v4.value_grad_plan(shapes, kw.get("Q", 300), len(shapes),
                                  kw.get("P", 4), kw.get("D", 64),
                                  getattr(torch, dtype))
        seen |= {f"8b/{plan.body}", f"8b/table={plan.table}",
                 *(f"8b/walk={w}" for w in plan.walks)}
    assert seen >= {"bfloat16/2_lanes", "bfloat16/4_lanes",
                    "bfloat16/8_lanes", "bfloat16/16_lanes",
                    "bfloat16/single", "float32/4_lanes", "float32/8_lanes",
                    "float32/16_lanes", "float32/32_lanes", "P=1", "P=8",
                    "P=9", "P=64", "draw=whole", "draw=one", "draw=wide",
                    "loc=bfloat16", "loc=float32", "non-square",
                    "8b/grouped", "8b/lanes", "8b/table=shared",
                    "8b/table=global", "8b/walk=group", "8b/walk=warp"}


def test_bench_v4_kernels_runs_on_the_cpu():
    """The per-kernel benchmark on the CPU: the plain versions on its tiny
    cases (one of each benchmark), finite, no timing, nothing launched."""
    kernels = (v4.ms_deform_attn_v4_cuda, v4.ms_deform_attn_v4_bwd_value_cuda,
               v4.ms_deform_attn_v4_bwd_loc_weight_cuda)
    before = [k.launches for k in kernels]
    rows = bench.run("cpu", bench.TINY)
    assert [r["case"] for r in rows] == list(bench.TINY)
    for row in rows:
        assert row["finite"] and row["device"] == "cpu"
        assert all(row[f"{k}_ms"] is None for k in bench.KERNELS)
    assert [k.launches for k in kernels] == before
