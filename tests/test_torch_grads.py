"""Gradients of the port's differentiable ops against JAX's, on the CPU.

The plain versions of the kernels with a backward (deformable attention,
attention, GroupNorm+SiLU) are differentiated by autograd, or by their
autograd function's plain backward, and held against ``jax.grad`` of the
JAX package's XLA paths and, for the deformable op, against the Pallas v5
backward in interpret mode.  Inputs come from numpy seeds, fp32; the
tolerance is 1e-5 x the gradient's scale (the same sums in another order).
The CUDA routes' autograd wiring is checked with the launchers swapped for
plain stand-ins.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops import attention as jatt
from mm_interleaved_tpu.ops.group_norm import group_norm_silu as j_gn_silu
from mm_interleaved_tpu.ops.ms_deform_attn import (
    ms_deform_attn as j_msda,
    ms_deform_attn_multi_image as j_msda_mi,
)
from mm_interleaved_tpu.ops.ms_deform_attn_pallas_v5 import (
    _ms_deform_attn_pallas_v5_bwd,
)
from mm_interleaved_tpu_torch.ops import cuda_build
from mm_interleaved_tpu_torch.ops import flash_attention as fa
from mm_interleaved_tpu_torch.ops import group_norm as tgn
from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as kmod
from mm_interleaved_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn, ms_deform_attn_multi_image,
)

from _torch_parity import t

REL = 1e-5


def close_scaled(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _deform_inputs(shapes, Lq, P, B=2, H=4, D=16, seed=0):
    """Locations spill past [0, 1], so out-of-bounds corners are covered."""
    rs = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = (rs.randn(B, S, H, D) * 0.1).astype(np.float32)
    loc = rs.uniform(-0.2, 1.2, (B, Lq, H, len(shapes), P, 2)).astype(
        np.float32)
    w = rs.rand(B, Lq, H, len(shapes), P).astype(np.float32)
    dout = rs.randn(B, Lq, H * D).astype(np.float32)
    return value, loc, w, dout


def _torch_grads(fn, inputs, dout):
    ins = [t(x).requires_grad_(True) for x in inputs]
    out = fn(*ins)
    out.backward(t(dout))
    return [x.grad for x in ins]


@pytest.mark.parametrize("shapes,Lq,P", [
    (((8, 8), (4, 4), (2, 2)), 50, 4),
    (((12, 16), (6, 8), (3, 4)), 21, 6),  # non-square levels
    (((16, 16),), 84, 4),  # one level (Extractor)
])
def test_plain_deform_grads_match_jax_autodiff(shapes, Lq, P):
    value, loc, w, dout = _deform_inputs(shapes, Lq, P)
    _, vjp = jax.vjp(lambda a, b, c: j_msda(a, shapes, b, c),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    want = vjp(jnp.asarray(dout))
    got = _torch_grads(lambda a, b, c: ms_deform_attn(a, shapes, b, c),
                       (value, loc, w), dout)
    for g, wnt in zip(got, want):
        close_scaled(g, wnt)


def test_plain_deform_grads_match_pallas_v5_backward_interpret():
    """The v5 backward kernels (grad value by the transposed product, grad
    locations and weights by the hat factors) in interpret mode."""
    shapes, Lq, P = ((16, 16), (8, 8)), 40, 8
    value, loc, w, dout = _deform_inputs(shapes, Lq, P)
    want = _ms_deform_attn_pallas_v5_bwd(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
        jnp.asarray(dout), tile_q=32, interpret=True)
    got = kmod.ms_deform_attn_plain_backward(t(value), shapes, t(loc), t(w),
                                             t(dout))
    for g, wnt in zip(got, want):
        close_scaled(g, wnt)


def test_multi_image_grads_match_jax():
    """The image axis folded into the batch, a masked image included."""
    rs = np.random.RandomState(3)
    shapes = ((8, 8), (4, 4))
    B, n, H, D, P, Lq = 2, 3, 2, 8, 2, 24
    value = rs.randn(B, n, 80, H, D).astype(np.float32)
    loc = rs.uniform(-0.1, 1.1, (B, Lq, H, n, 2, P, 2)).astype(np.float32)
    w = rs.rand(B, Lq, H, n, 2, P).astype(np.float32)
    w[0, :, :, 2] = 0.0
    dout = rs.randn(B, Lq, H * D).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_msda_mi(a, shapes, b, c),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    want = vjp(jnp.asarray(dout))
    got = _torch_grads(
        lambda a, b, c: ms_deform_attn_multi_image(a, shapes, b, c),
        (value, loc, w), dout)
    for g, wnt in zip(got, want):
        close_scaled(g, wnt)


def _attn_case(case, D=16, seed=0):
    rs = np.random.RandomState(seed)
    B, H = 2, 3
    Tq, Tk = (5, 9) if case == "cross" else (11, 11)
    q, k, v = (rs.randn(B, T, H, D).astype(np.float32)
               for T in (Tq, Tk, Tk))
    dout = rs.randn(B, Tq, H, D).astype(np.float32)
    kw = {}
    if case == "causal":
        kw = dict(causal=True)
    if case in ("causal_padded", "padded"):
        seg = np.ones((B, Tq), np.int32)
        seg[1, :4] = 0  # row 1 is left-padded by 4
        kw = dict(causal=case == "causal_padded", q_segment_ids=seg,
                  kv_segment_ids=seg)
    if case == "cross":
        kw = dict(causal=True)  # end-aligned: Tq < Tk
    return q, k, v, dout, kw


@pytest.mark.parametrize("case", ["plain", "causal", "causal_padded",
                                  "padded", "cross"])
def test_plain_attention_grads_match_jax_xla_attention(case):
    q, k, v, dout, kw = _attn_case(case)
    jkw = {a: jnp.asarray(b) if isinstance(b, np.ndarray) else b
           for a, b in kw.items()}
    scale = q.shape[-1] ** -0.5

    def jfn(a, b, c):
        return jatt._xla_attention(a, b, c, None, None, jkw.get("causal",
                                                                False),
                                   scale, jkw.get("q_segment_ids"),
                                   jkw.get("kv_segment_ids"))

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tkw = {a: t(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()}
    got = fa.attention_plain_backward(t(q), t(k), t(v), t(dout), **tkw)
    for g, wnt in zip(got, want):
        close_scaled(g, wnt)


@pytest.mark.parametrize("eps,shape,G", [
    (1e-5, (2, 8, 8, 32), 4),  # UNet ResnetBlock
    (1e-6, (2, 4, 4, 24), 8),  # C not a power of 2
])
def test_group_norm_silu_grads_match_jax(eps, shape, G):
    """Through `GroupNormSiLUFunction`'s recompute backward (and the plain
    statistics under autograd) against ``jax.grad`` of the JAX op."""
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    dout = rs.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: j_gn_silu(a, b, c, G, eps),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(dout))
    ins = [t(a).requires_grad_(True) for a in (x, scale, bias)]
    out = tgn.group_norm_silu(*ins, G, eps)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__.startswith("GroupNormSiLUFunction")
    out.backward(t(dout))
    for a, wnt in zip(ins, want):
        close_scaled(a.grad, wnt)


def test_deform_cuda_route_differentiates_through_the_backward_kernels(
        monkeypatch):
    """The CUDA route's autograd function, with its three launchers swapped
    for plain stand-ins: the output has a ``grad_fn``, and its backward
    calls both backward launchers and returns the plain gradients."""
    shapes, Lq, P = ((8, 8), (4, 4)), 12, 2
    value, loc, w, dout = _deform_inputs(shapes, Lq, P)
    calls = []

    def fwd(v, s, lo, we):
        calls.append("fwd")
        return kmod.ms_deform_attn_plain(v, s, lo, we)

    def bwd_value(v, s, lo, we, go):
        calls.append("value")
        return kmod.ms_deform_attn_plain_backward(v, s, lo, we, go)[0]

    def bwd_loc_weight(v, s, lo, we, go):
        calls.append("loc_weight")
        return kmod.ms_deform_attn_plain_backward(v, s, lo, we, go)[1:]

    monkeypatch.setattr(kmod, "ms_deform_attn_cuda", fwd)
    monkeypatch.setattr(kmod, "ms_deform_attn_bwd_value_cuda", bwd_value)
    monkeypatch.setattr(kmod, "ms_deform_attn_bwd_loc_weight_cuda",
                        bwd_loc_weight)
    ins = [t(x).requires_grad_(True) for x in (value, loc, w)]
    out = kmod.MSDeformAttnFunction.apply(ins[0], shapes, ins[1], ins[2])
    assert out.grad_fn is not None
    out.backward(t(dout))
    assert calls == ["fwd", "value", "loc_weight"]
    want = kmod.ms_deform_attn_plain_backward(t(value), shapes, t(loc), t(w),
                                              t(dout))
    for a, b in zip(ins, want):
        close_scaled(a.grad, b.numpy(), 0)


def test_bare_forward_wrappers_refuse_a_recorded_call(monkeypatch):
    """Kernel 1's bare wrapper (and flash attention's) calls `forbid_grad`
    before any launch: a call that autograd records raises instead of
    returning an output without a gradient."""
    value, loc, w, _ = _deform_inputs(((4, 4),), 3, 2)
    monkeypatch.setattr(kmod, "_check", lambda *a: (2, 16, 3, 4, 16, 1, 2))
    with pytest.raises(NotImplementedError, match="no gradient"):
        kmod.ms_deform_attn_cuda(t(value).requires_grad_(True), ((4, 4),),
                                 t(loc), t(w))
    q = torch.zeros(1, 4, 1, 8, requires_grad=True)
    monkeypatch.setattr(fa, "_check", lambda *a: ((1, 4, 4, 1, 8),
                                                  (None, None)))
    with pytest.raises(NotImplementedError, match="no gradient"):
        fa.flash_attention(q, q, q)
    with torch.no_grad():  # not recorded: passes the check
        cuda_build.forbid_grad("x", q)
