"""The v1 forward's arithmetic on kernel 1's grouped body (kernel 9,
`csrc/ms_deform_attn_v1.cu`: `deform::forward_gather` with v1's blend) in
plain torch, held against `ms_deform_attn_v1_plain`.

The body takes a query-head's L*P samples in rounds of 32: a group of G
lanes (D's 16-byte vectors) takes samples grp * iters + it of the round,
in order, and adds each sample's blend into its fp32 sums; after the last
round the groups' sums fold by a butterfly (the lanes that differ in G,
then 2G, ...).  A sample's blend is v1's: the corners of
``deform::corners`` (x = loc * w - 0.5, the product rounded, then the
difference: the plain version's rounding), row weights r0 = 1 - ly and
r1 = ly rounded to the value's dtype, t = r0 v[y0] + r1 v[y1] per column,
s = aw (1 - lx) t_x0 + aw lx t_x1; a corner outside the grid is zeros.

Checked: the emulated order within 1e-6 of the plain version's scale in
fp32 and within 2 bf16 ulps of it in bf16 (the same products, the sums
over samples in another order), at G = 4, 8 and 16, with corners outside
the grid, whole-texel coordinates and L * P over 32; the wrapper's refusal
of a misaligned value where the body is "grouped"; and that
`chip_smoke.py`'s `V1_EDGES` reach both bodies, every group width and the
refusal.  No JAX: the plain version is held to the JAX kernel in
tests/test_torch_deform_baselines.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk
from mm_interleaved_tpu_torch.ops import ms_deform_attn_v1 as v1

BF16, FP32 = torch.bfloat16, torch.float32

# name: (level shapes, Q, P, D, dtype, location draw)
CASES = {
    "g4_out_of_grid": (((12, 16), (6, 8), (3, 4)), 21, 4, 16, FP32, "wide"),
    "g8_bf16": (((16, 16), (8, 8)), 17, 8, 64, BF16, "wide"),
    "g16_kinks": (((8, 8), (4, 4)), 13, 9, 64, FP32, "whole"),
    "g4_bf16_lp_over_32": (((8, 16), (4, 8), (2, 4)), 11, 12, 32, BF16,
                           "wide"),
    "g16_bf16": (((7, 9),), 19, 5, 128, BF16, "wide"),
}


def _inputs(shapes, Q, P, D, dtype, draw, B=2, H=2, seed=0):
    rng = np.random.RandomState(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2))
    if draw == "whole":
        for lid, (h, w) in enumerate(shapes):
            for axis, n in ((0, w), (1, h)):
                k = np.floor(loc[:, :, :, lid, :, axis] * n)
                loc[:, :, :, lid, :, axis] = (k + 0.5) / n
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (t(rng.randn(B, S, H, D)).to(dtype), shapes, t(loc),
            t(rng.rand(B, Q, H, L, P)))


def blends(value, shapes, loc, w):
    """Each sample's blend ``[N, Q, H, L*P, D]`` in fp32, v1's arithmetic
    on its four corners as the grouped body forms it."""
    N, S, H, D = value.shape
    out = []
    start = 0
    for lid, (h, w_) in enumerate(shapes):
        v_l = value[:, start:start + h * w_].permute(0, 2, 1, 3).float()
        x = loc[:, :, :, lid, :, 0].float() * w_ - 0.5  # [N, Q, H, P]
        y = loc[:, :, :, lid, :, 1].float() * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        aw = w[:, :, :, lid].float()
        r0 = (1.0 - fy).to(value.dtype).float()[..., None]
        r1 = fy.to(value.dtype).float()[..., None]
        c0 = (aw * (1.0 - fx))[..., None]
        c1 = (aw * fx)[..., None]

        def corner(dx, dy):
            ix, iy = x0.long() + dx, y0.long() + dy
            ok = (ix >= 0) & (ix < w_) & (iy >= 0) & (iy < h)
            idx = (iy.clamp(0, h - 1) * w_ + ix.clamp(0, w_ - 1))
            idx = idx.permute(0, 2, 1, 3).reshape(N, H, -1)
            got = torch.gather(v_l, 2, idx[..., None].expand(-1, -1, -1, D))
            got = got.view(N, H, -1, x.shape[3], D).permute(0, 2, 1, 3, 4)
            return torch.where(ok[..., None], got, torch.zeros_like(got))

        t0 = r0 * corner(0, 0) + r1 * corner(0, 1)
        t1 = r0 * corner(1, 0) + r1 * corner(1, 1)
        out.append(c0 * t0 + c1 * t1)
        start += h * w_
    return torch.cat(out, dim=3)


def grouped_forward(value, shapes, loc, w):
    """The grouped body's order over a query-head's samples; ``[N, Q,
    H*D]`` in the value's dtype."""
    N, S, H, D = value.shape
    Q = loc.shape[1]
    G = dk._group_lanes(D, value.dtype)
    assert G, "not a grouped width"
    NG = 32 // G
    s = blends(value, shapes, loc, w)
    LP = s.shape[3]
    acc = torch.zeros(NG, N, Q, H, D)
    for base in range(0, LP, 32):
        R = min(32, LP - base)
        iters = (R + NG - 1) // NG
        for grp in range(NG):
            for it in range(iters):
                j = grp * iters + it
                if j < R:
                    acc[grp] = acc[grp] + s[:, :, :, base + j]
    m = 1
    while m < NG:  # the butterfly: lanes G * m apart
        acc = acc + acc[torch.arange(NG) ^ m]
        m *= 2
    return acc[0].reshape(N, Q, H * D).to(value.dtype)


def _assert_rel(got, want, rel):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("case", CASES)
def test_grouped_order_matches_plain(case):
    """The samples summed in the body's order: within 1e-6 of the plain
    version's scale in fp32, 2 bf16 ulps in bf16 (the output's own
    rounding and the order of the sums)."""
    shapes, Q, P, D, dtype, draw = CASES[case]
    args = _inputs(shapes, Q, P, D, dtype, draw)
    want = v1.ms_deform_attn_v1_plain(*args)
    got = grouped_forward(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    _assert_rel(got, want, 1e-6 if dtype == FP32 else 2 * 2.0 ** -8)


def test_cases_reach_every_group_width():
    widths = {dk._group_lanes(c[3], c[4]) for c in CASES.values()}
    assert widths == {4, 8, 16}
    assert any(len(c[0]) * c[2] > 32 for c in CASES.values())


def _misaligned(x):
    buf = torch.zeros(x.numel() + 16, dtype=x.dtype)
    start = next(i for i in range(1, 16)
                 if (buf.data_ptr() + i * x.element_size()) % 16)
    return buf[start:start + x.numel()].view(x.shape).copy_(x)


@pytest.mark.parametrize("D,dtype,match", [
    (64, BF16, "16-byte"), (16, FP32, "16-byte"),
    (20, FP32, "CUDA"),  # the per-channel body: any alignment
    (16, BF16, "CUDA"),
])
def test_misaligned_value_refused_before_any_launch(D, dtype, match):
    """Where `forward_variant` says "grouped", a value off a 16-byte
    boundary raises before the device check and counts nothing."""
    args = [_misaligned(torch.zeros(1, 16, 2, D, dtype=dtype)), ((4, 4),),
            torch.zeros(1, 3, 2, 1, 2, 2, dtype=dtype),
            torch.zeros(1, 3, 2, 1, 2, dtype=dtype)]
    before = v1.ms_deform_attn_v1_cuda.launches
    with pytest.raises(ValueError, match=match):
        v1.ms_deform_attn_v1_cuda(*args)
    assert v1.ms_deform_attn_v1_cuda.launches == before


def test_smoke_v1_edges_reach_every_body():
    """`chip_smoke.py`'s `V1_EDGES`: D = 16, 32 and 128, fp32, bf16
    locations, corners outside the grid, whole-texel coordinates, the
    "channel" body at D = 20 (fp32), both bodies and every group width,
    and a misaligned value."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    seen = set()
    for kw in smoke.V1_EDGES.values():
        D = kw.get("D", 64)
        name = kw.get("dtype", "bfloat16")
        dtype = getattr(torch, name)
        body = dk.forward_variant(D, dtype)
        if body == "grouped":
            body = f"G={dk._group_lanes(D, dtype)}"
        seen |= {f"D={D}", name, body, f"draw={kw.get('draw', 'wide')}",
                 f"loc={kw.get('loc_dtype', 'float32')}"}
        if kw.get("misaligned"):
            seen.add(f"misaligned/{dk.forward_variant(D, dtype)}")
    assert seen >= {"D=16", "D=32", "D=128", "float32", "bfloat16",
                    "loc=bfloat16", "loc=float32", "draw=wide",
                    "draw=whole", "channel", "G=4", "G=8", "G=16",
                    "misaligned/grouped"}
    assert smoke.V1_EDGES["channel_fp32_d20"] == dict(dtype="float32", D=20)
