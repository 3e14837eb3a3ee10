"""The benchmark's deformable formulations: the port's plain v1 and v4
against the JAX package's Pallas kernels in interpret mode, the three plain
formulations against each other, the CUDA wrappers' refusal of CPU
tensors, and the benchmark entry point on the CPU.

Inputs are numpy draws (the shapes of tests/test_pallas_kernel.py, with
locations in [-0.2, 1.2] so that out-of-grid corners are covered).
Tolerances: fp32 within 1e-5 of the output's scale (the same sums in
another order); bf16 within 1e-2 of it (the JAX v4 kernel also rounds its
x-weights to bf16 for its MXU expansion, which the port does not copy).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_pallas
from mm_interleaved_tpu.ops.ms_deform_attn_pallas_v4 import (
    ms_deform_attn_pallas_v4,
)
from mm_interleaved_tpu_torch import bench_deform_kernel as bench
from mm_interleaved_tpu_torch.ops import ms_deform_attn_v1 as v1
from mm_interleaved_tpu_torch.ops import ms_deform_attn_v4 as v4
from mm_interleaved_tpu_torch.ops.ms_deform_attn_cuda import (
    ms_deform_attn_plain,
)

SHAPES = [
    (((12, 16), (6, 8), (3, 4)), 50, 6),  # non-square levels, odd sizes
    (((16, 16), (8, 8)), 40, 8),
    (((8, 8),), 33, 2),  # one level
    (((7, 9),), 21, 4),  # h coprime with the TPU's lane count
]


def _inputs(shapes, Lq, P, B=2, H=4, D=16, seed=0):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, H, D).astype(np.float32) * 0.1
    loc = rng.uniform(-0.2, 1.2, (B, Lq, H, len(shapes), P, 2)).astype(
        np.float32)
    w = rng.rand(B, Lq, H, len(shapes), P).astype(np.float32)
    return value, loc, w


def _args(shapes, value, loc, w, dtype=torch.float32):
    """The port's arguments: ``(value, shapes, loc, w)``."""
    return (torch.from_numpy(value).to(dtype), shapes, torch.from_numpy(loc),
            torch.from_numpy(w))


def _jax(fn, value, shapes, loc, w, dtype=jnp.float32):
    out = fn(jnp.asarray(value).astype(dtype), shapes, jnp.asarray(loc),
             jnp.asarray(w), tile_q=32, interpret=True)
    return np.asarray(out, np.float32)


def _assert_rel(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("shapes,Lq,P", SHAPES)
def test_v4_plain_matches_pallas_v4_interpret(shapes, Lq, P):
    value, loc, w = _inputs(shapes, Lq, P)
    want = _jax(ms_deform_attn_pallas_v4, value, shapes, loc, w)
    got = v4.ms_deform_attn_v4(*_args(shapes, value, loc, w))
    _assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("shapes,Lq,P", SHAPES)
def test_v1_plain_matches_pallas_v1_interpret(shapes, Lq, P):
    value, loc, w = _inputs(shapes, Lq, P)
    want = _jax(ms_deform_attn_pallas, value, shapes, loc, w)
    got = v1.ms_deform_attn_v1(*_args(shapes, value, loc, w))
    _assert_rel(got, want, 1e-5)


@pytest.mark.parametrize("name", ["v1", "v4"])
def test_bf16_plain_matches_pallas_interpret(name):
    shapes, Lq, P = SHAPES[0]
    value, loc, w = _inputs(shapes, Lq, P)
    jfn, tfn = ((ms_deform_attn_pallas, v1.ms_deform_attn_v1) if name == "v1"
                else (ms_deform_attn_pallas_v4, v4.ms_deform_attn_v4))
    want = _jax(jfn, value, shapes, loc, w, jnp.bfloat16)
    got = tfn(*_args(shapes, value, loc, w, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, 1e-2)


@pytest.mark.parametrize("shapes,Lq,P", SHAPES)
def test_three_plain_formulations_agree(shapes, Lq, P):
    args = _args(shapes, *_inputs(shapes, Lq, P, seed=1))
    want = ms_deform_attn_plain(*args).numpy()
    _assert_rel(v1.ms_deform_attn_v1_plain(*args), want, 1e-5)
    _assert_rel(v4.ms_deform_attn_v4_plain(*args), want, 1e-5)


def test_v4_plain_chunks_queries(monkeypatch):
    """A chunk budget below one query's bilinear matrix still takes every
    query, one at a time (the same sums, blocked otherwise by bmm)."""
    shapes, Lq, P = SHAPES[1]
    args = _args(shapes, *_inputs(shapes, Lq, P))
    want = v4.ms_deform_attn_v4_plain(*args).numpy()
    monkeypatch.setattr(v4, "_CHUNK_BYTES", 1)
    _assert_rel(v4.ms_deform_attn_v4_plain(*args), want, 1e-6)


@pytest.mark.parametrize("mod,kernel", [(v1, "ms_deform_attn_v1_cuda"),
                                        (v4, "ms_deform_attn_v4_cuda")])
def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing(mod, kernel):
    shapes = ((4, 4),)
    args = _args(shapes, *_inputs(shapes, 3, 2))
    wrapper = getattr(mod, kernel)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before


def test_bench_runs_on_the_cpu():
    """`run("cpu")` on the tiny case: one finite row per formulation, each
    within the bf16 tolerance of kernel 1's plain version, no timing, and
    no kernel launched."""
    before = (v1.ms_deform_attn_v1_cuda.launches,
              v4.ms_deform_attn_v4_cuda.launches)
    res = bench.run("cpu", bench.TINY)
    assert [(r["case"], r["formulation"]) for r in res["rows"]] == [
        ("tiny", f) for f in bench.FORMULATIONS]
    for row in res["rows"]:
        assert row["finite"] and row["ms"] is None
        assert row["rel_diff_vs_kernel1"] <= 2e-2
    assert res["calls"] == dict.fromkeys(bench.FORMULATIONS, 1)
    assert (v1.ms_deform_attn_v1_cuda.launches,
            v4.ms_deform_attn_v4_cuda.launches) == before
    value = res["inputs"]["tiny"][0]
    assert value.dtype == torch.bfloat16
    assert tuple(value.shape) == (2, 252, 2, 16)
