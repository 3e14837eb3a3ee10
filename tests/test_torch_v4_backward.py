"""The v4 deformable backward and the v4-against-v5 benchmark: the port's
plain backward against the JAX package's Pallas backward in interpret mode,
against autograd through the plain forwards (v4's and kernel 1's), its
query chunking, the CUDA wrappers' refusal of CPU tensors, and the
benchmark entry point on the CPU.

Inputs are numpy draws (the shapes of tests/test_torch_deform_baselines.py,
locations in [-0.2, 1.2] so that out-of-grid corners are covered).
Tolerances, each over the gradient's largest magnitude: fp32 1e-5 (the same
sums in another order); bf16 1e-2 (the JAX backward also rounds its
x-weights, ``g`` and ``wxe * dA`` to bf16 for the MXU, which the port does
not copy).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops.ms_deform_attn_pallas_v4 import (
    _ms_deform_attn_pallas_v4_bwd,
)
from mm_interleaved_tpu_torch import bench_v5_kernel as bench
from mm_interleaved_tpu_torch.ops import ms_deform_attn_v4 as v4
from mm_interleaved_tpu_torch.ops.ms_deform_attn_cuda import (
    ms_deform_attn_plain_backward,
)

SHAPES = [
    (((12, 16), (6, 8), (3, 4)), 50, 6),  # non-square levels, odd sizes
    (((16, 16), (8, 8)), 40, 8),
    (((8, 8),), 33, 2),  # one level
    (((7, 9),), 21, 4),  # h coprime with the TPU's lane count
]


def _inputs(shapes, Lq, P, B=2, H=4, D=16, seed=0):
    """value, loc, w and dOut as numpy fp32."""
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, H, D).astype(np.float32) * 0.1
    loc = rng.uniform(-0.2, 1.2, (B, Lq, H, len(shapes), P, 2)).astype(
        np.float32)
    w = rng.rand(B, Lq, H, len(shapes), P).astype(np.float32)
    d_out = rng.randn(B, Lq, H * D).astype(np.float32)
    return value, loc, w, d_out


def _args(shapes, value, loc, w, d_out, dtype=torch.float32):
    """The port's arguments ``(value, shapes, loc, w, grad_out)``, value
    and dOut in ``dtype``."""
    return (torch.from_numpy(value).to(dtype), shapes, torch.from_numpy(loc),
            torch.from_numpy(w), torch.from_numpy(d_out).to(dtype))


def _jax_bwd(shapes, value, loc, w, d_out, dtype=jnp.float32, tile_q=32):
    grads = _ms_deform_attn_pallas_v4_bwd(
        jnp.asarray(value).astype(dtype), shapes, jnp.asarray(loc),
        jnp.asarray(w), jnp.asarray(d_out).astype(dtype), tile_q=tile_q,
        interpret=True)
    return [np.asarray(g, np.float32) for g in grads]


def _assert_rel(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, rel * scale)


def _check_grads(got, want, rel):
    for name, g, r in zip(("d_value", "d_loc", "d_w"), got, want):
        assert g.shape == tuple(r.shape), name
        _assert_rel(g, r, rel)


@pytest.mark.parametrize("shapes,Lq,P", SHAPES)
def test_plain_backward_matches_pallas_v4_interpret(shapes, Lq, P):
    ins = _inputs(shapes, Lq, P)
    want = _jax_bwd(shapes, *ins)
    got = v4.ms_deform_attn_v4_plain_backward(*_args(shapes, *ins))
    assert [g.dtype for g in got] == [torch.float32] * 3
    _check_grads(got, want, 1e-5)


def test_bf16_plain_backward_matches_pallas_v4_interpret():
    shapes, Lq, P = SHAPES[0]
    ins = _inputs(shapes, Lq, P)
    # both sides take dOut rounded to bf16
    ins = ins[:3] + (np.asarray(torch.from_numpy(ins[3]).bfloat16().float()),)
    want = _jax_bwd(shapes, *ins, dtype=jnp.bfloat16)
    got = v4.ms_deform_attn_v4_plain_backward(
        *_args(shapes, *ins, dtype=torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]
    _check_grads(got, want, 1e-2)


def test_plain_backward_ignores_padded_queries():
    """Q = 19 against the JAX side's 16-query tiles (its padded queries
    must not leak into dV), as tests/test_pallas_kernel.py checks the
    JAX kernel."""
    shapes = ((8, 8),)
    ins = _inputs(shapes, 19, 3, B=1, H=2, D=8, seed=1)
    want = _jax_bwd(shapes, *ins, tile_q=16)
    got = v4.ms_deform_attn_v4_plain_backward(*_args(shapes, *ins))
    _check_grads(got, want, 1e-5)


@pytest.mark.parametrize("shapes,Lq,P", SHAPES)
def test_plain_backward_matches_autograd_of_both_plain_forwards(shapes, Lq,
                                                               P):
    """Autograd through v4's plain forward (clamp and abs) and through
    kernel 1's (the floor-based blend) give the same gradients away from
    the hat's kinks, which random fp32 locations do not hit."""
    args = _args(shapes, *_inputs(shapes, Lq, P, seed=2))
    got = v4.ms_deform_attn_v4_plain_backward(*args)
    with torch.enable_grad():
        ins = [args[i].clone().requires_grad_() for i in (0, 2, 3)]
        out = v4.ms_deform_attn_v4_plain(ins[0], shapes, ins[1], ins[2])
        want = torch.autograd.grad(out, ins, args[4])
    _check_grads(got, want, 1e-5)
    _check_grads(got, ms_deform_attn_plain_backward(*args), 1e-5)


def test_plain_backward_chunks_queries(monkeypatch):
    """A chunk budget below one query's matrix still takes every query,
    one at a time."""
    shapes, Lq, P = SHAPES[1]
    args = _args(shapes, *_inputs(shapes, Lq, P))
    want = v4.ms_deform_attn_v4_plain_backward(*args)
    monkeypatch.setattr(v4, "_CHUNK_BYTES", 1)
    _check_grads(v4.ms_deform_attn_v4_plain_backward(*args), want, 1e-6)


@pytest.mark.parametrize("kernel", ["ms_deform_attn_v4_bwd_value_cuda",
                                    "ms_deform_attn_v4_bwd_loc_weight_cuda"])
def test_cuda_backward_wrappers_refuse_cpu_tensors_and_count_nothing(kernel):
    shapes = ((4, 4),)
    args = _args(shapes, *_inputs(shapes, 3, 2))
    wrapper = getattr(v4, kernel)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before


def test_bench_draws_the_scripts_locations():
    """Clustered locations lie within their band around the centre of the
    query's grid cell (``grid``) or of the image (``centre``); uniform ones
    within [0.02, 0.98]; the value is bf16, 0.1 x a standard normal draw."""
    inputs = bench.make_inputs(bench.TINY, "cpu")
    for case, c in bench.TINY.items():
        value, shapes, loc, w = inputs[case]
        assert value.dtype == torch.bfloat16 and loc.dtype == torch.float32
        assert 0 < float(value.float().abs().max()) < 1.0
        loc = loc.double().numpy()
        if c["uniform"]:
            assert loc.min() >= 0.02 and loc.max() <= 0.98
        elif c["cluster"] == "centre":
            assert np.abs(loc - 0.5).max() <= 3 / 16 + 1e-6
        else:
            g = int(round(c["Q"] ** 0.5))
            gy, gx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
            ref = np.stack([(gx + .5) / g, (gy + .5) / g], -1).reshape(
                1, -1, 1, 1, 1, 2)
            assert np.abs(loc - ref).max() <= 1 / g + 1e-6
    assert {(c["cluster"], c["uniform"]) for c in bench.TINY.values()} == {
        ("grid", False), ("centre", False), ("grid", True)}


def test_bench_runs_on_the_cpu():
    """`run("cpu")` on the tiny cases: one finite row per case, v4 within
    the bf16 tolerance of v5 in the forward and every gradient, no timing,
    and no kernel launched."""
    kernels = (v4.ms_deform_attn_v4_cuda, v4.ms_deform_attn_v4_bwd_value_cuda,
               v4.ms_deform_attn_v4_bwd_loc_weight_cuda)
    before = [k.launches for k in kernels]
    res = bench.run("cpu", bench.TINY)
    assert [r["case"] for r in res["rows"]] == list(bench.TINY)
    for row in res["rows"]:
        assert row["finite"] and row["fwd_v4_ms"] is None
        for key in ("fwd", "d_value", "d_loc", "d_w"):
            assert row[f"rel_diff_{key}"] <= 2e-2, (row["case"], key)
    assert res["calls"] == dict.fromkeys(bench.CALLS, len(bench.TINY))
    assert [k.launches for k in kernels] == before
    grads = res["outputs"]["tiny"]["v4_grads"]
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32]
