"""PyTorch port vs JAX: configs, ops and the deformable-attention kernel
module (`mm_interleaved_tpu_torch.ops`).

Inputs come from numpy seeds and go through both frameworks in fp32 on the
CPU.  Tolerances: 1e-5 absolute where the two sides compute the same sums
in a different order (deformable attention, resize matrices), rtol 1e-5 /
atol 1e-6 for elementwise ops.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mm_interleaved_tpu.configs as jcfg
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu.ops import attention as jatt
from mm_interleaved_tpu.ops import pos_embed as jpe
from mm_interleaved_tpu.ops.ms_deform_attn import (
    ms_deform_attn as j_msda,
    ms_deform_attn_multi_image as j_msda_mi,
)
from mm_interleaved_tpu.ops.ms_deform_attn_pallas_v5 import (
    ms_deform_attn_pallas_v5,
)
from mm_interleaved_tpu.ops.rmsnorm import rms_norm as j_rms
from mm_interleaved_tpu.ops.rotary import (
    apply_rotary_embedding as j_rope, rotary_cos_sin as j_cos_sin,
)
from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as kmod
from mm_interleaved_tpu_torch.ops.attention import dot_product_attention
from mm_interleaved_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn, ms_deform_attn_multi_image,
)
from mm_interleaved_tpu_torch.ops.pos_embed import (
    resize_abs_pos_embed, resize_nhwc, resized_sincos_table,
)
from mm_interleaved_tpu_torch.ops.rmsnorm import rms_norm
from mm_interleaved_tpu_torch.ops.rotary import (
    apply_rotary_embedding, rotary_cos_sin,
)

from _torch_parity import close, t


@pytest.mark.parametrize("preset,kwargs", [
    ("tiny_config", {}),
    ("tiny_config", dict(with_image_decoder=False, scan_layers=False)),
    ("small_config", {}),
    ("base_config", dict(with_image_decoder=False)),
    ("base_config", {}),
    ("flagship_config", dict(max_num_images=2)),
])
def test_presets_match_jax_field_for_field(preset, kwargs):
    j = getattr(jcfg, preset)(**kwargs)
    p = getattr(tcfg, preset)(**kwargs)

    def names(c):
        return {f.name: (type(getattr(c, f.name)).__name__,
                         names(getattr(c, f.name))
                         if dataclasses.is_dataclass(getattr(c, f.name))
                         else None)
                for f in dataclasses.fields(c)}

    assert dataclasses.asdict(j) == dataclasses.asdict(p)
    assert names(j) == names(p)
    assert p.llm.compute_dtype == getattr(torch, j.llm.dtype)


@pytest.mark.parametrize("n_in,n_out,method", [
    (16, 64, "cubic"), (16, 32, "cubic"), (16, 8, "cubic"), (16, 4, "cubic"),
    (56, 64, "bilinear"), (224, 256, "bilinear"), (16, 8, "bilinear"),
    (4, 16, "bilinear"), (4, 2, "bilinear"),
])
def test_resize_matches_jax_image_resize(n_in, n_out, method):
    """Antialiased shrink and Keys a=-0.5 cubic: torch's interpolate
    differs from both, the port rebuilds JAX's matrices (atol 1e-5)."""
    x = np.random.RandomState(0).randn(2, n_in, n_in, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n_out, n_out, 3), method)
    close(resize_nhwc(t(x), (n_out, n_out), method), want, 0, 1e-5)


@pytest.mark.parametrize("dim,grid,tgt", [(32, 4, 16), (32, 4, 2),
                                          (64, 16, 64), (64, 16, 8)])
def test_resized_pos_tables_match_jax(dim, grid, tgt):
    table = jpe.get_2d_sincos_pos_embed(dim, grid)
    want = jpe.resize_abs_pos_embed(jnp.asarray(table), grid, tgt)
    close(resized_sincos_table(dim, grid, tgt), want, 0, 1e-5)
    close(resize_abs_pos_embed(t(table), grid, tgt), want, 0, 1e-5)


@pytest.mark.parametrize("case", ["plain", "causal", "segments", "mask"])
def test_attention_matches_xla_path(case):
    rs = np.random.RandomState(0)
    B, Tq, Tk, H, D = 2, 5, 7, 3, 8
    q, k, v = (rs.randn(B, T, H, D).astype(np.float32)
               for T in (Tq, Tk, Tk))
    kw_j, kw_t = {}, {}
    causal = case == "causal"
    if case == "segments":
        qs = rs.randint(0, 2, (B, Tq)).astype(np.int32)
        ks = rs.randint(0, 2, (B, Tk)).astype(np.int32)
        qs[:, 0] = ks[:, 0] = 1  # every query keeps a key
        kw_j = dict(q_segment_ids=jnp.asarray(qs),
                    kv_segment_ids=jnp.asarray(ks))
        kw_t = dict(q_segment_ids=t(qs), kv_segment_ids=t(ks))
    mask = None
    if case == "mask":
        mask = rs.rand(B, 1, Tq, Tk) > 0.3
        mask[..., 0] = True
    want = jatt._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
        None if mask is None else jnp.asarray(mask), causal, D ** -0.5,
        kw_j.get("q_segment_ids"), kw_j.get("kv_segment_ids"),
    )
    got = dot_product_attention(
        t(q), t(k), t(v), causal=causal,
        mask=None if mask is None else t(mask), **kw_t,
    )
    close(got, want, 1e-5, 1e-6)


def test_rms_norm_and_rotary_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3, 16).astype(np.float32)
    w = rs.randn(16).astype(np.float32)
    close(rms_norm(t(x), t(w)), j_rms(jnp.asarray(x), jnp.asarray(w)),
          1e-5, 1e-6)
    cos, sin = rotary_cos_sin(16, 32)
    jc, js = j_cos_sin(16, 32)
    close(cos, jc, 1e-5, 1e-6)
    close(sin, js, 1e-5, 1e-6)
    pos = rs.randint(0, 32, (2, 5))
    k = rs.randn(2, 5, 3, 16).astype(np.float32)
    got = apply_rotary_embedding(t(x), t(k), cos, sin, t(pos))
    want = j_rope(jnp.asarray(x), jnp.asarray(k), jc, js, jnp.asarray(pos))
    for a, b in zip(got, want):
        close(a, b, 1e-5, 1e-5)


def _deform_inputs(shapes, Lq, P, B=2, H=4, D=16, seed=0, lo=-0.2, hi=1.2):
    """Locations spill past [0, 1], so out-of-bounds corners are covered."""
    rs = np.random.RandomState(seed)
    S = sum(h * w for h, w in shapes)
    value = (rs.randn(B, S, H, D) * 0.1).astype(np.float32)
    loc = rs.uniform(lo, hi, (B, Lq, H, len(shapes), P, 2)).astype(np.float32)
    w = rs.rand(B, Lq, H, len(shapes), P).astype(np.float32)
    return value, loc, w


@pytest.mark.parametrize("shapes,Lq,P", [
    (((8, 8), (4, 4), (2, 2)), 1, 4),  # decode: JAX one-hot path
    (((8, 8), (4, 4)), 16, 2),  # largest one-hot Lq
    (((8, 8), (4, 4), (2, 2)), 50, 4),  # gather path
    (((12, 16), (6, 8), (3, 4)), 21, 6),  # non-square levels
    (((16, 16),), 84, 4),  # one level (Extractor)
])
def test_plain_deform_matches_xla_oracle(shapes, Lq, P):
    value, loc, w = _deform_inputs(shapes, Lq, P)
    want = j_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                  jnp.asarray(w))
    before = kmod.ms_deform_attn_cuda.launches
    got = ms_deform_attn(t(value), shapes, t(loc), t(w))
    assert kmod.ms_deform_attn_cuda.launches == before  # CPU: plain path
    close(got, want, 0, 1e-5)


@pytest.mark.parametrize("shapes,Lq,P", [
    (((16, 16), (8, 8)), 40, 8),
    (((32, 32), (16, 16), (8, 8)), 70, 8),  # the MMFS levels, chunked
])
def test_plain_deform_matches_pallas_v5_interpret(shapes, Lq, P):
    value, loc, w = _deform_inputs(shapes, Lq, P)
    want = ms_deform_attn_pallas_v5(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(w),
        tile_q=32, interpret=True,
    )
    close(kmod.ms_deform_attn_plain(t(value), shapes, t(loc), t(w)), want,
          0, 1e-5)


@pytest.mark.parametrize("Lq", [1, 24])
def test_multi_image_matches_jax(Lq):
    rs = np.random.RandomState(3)
    shapes = ((8, 8), (4, 4))
    B, n, H, D, P = 2, 3, 2, 8, 2
    value = rs.randn(B, n, 80, H, D).astype(np.float32)
    loc = rs.uniform(-0.1, 1.1, (B, Lq, H, n, 2, P, 2)).astype(np.float32)
    w = rs.rand(B, Lq, H, n, 2, P).astype(np.float32)
    w[0, :, :, 2] = 0.0  # a masked image
    want = j_msda_mi(jnp.asarray(value), shapes, jnp.asarray(loc),
                     jnp.asarray(w))
    close(ms_deform_attn_multi_image(t(value), shapes, t(loc), t(w)), want,
          0, 1e-5)


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    value, loc, w = _deform_inputs(((4, 4),), 3, 2)
    before = kmod.ms_deform_attn_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        kmod.ms_deform_attn_cuda(t(value), ((4, 4),), t(loc), t(w))
    assert kmod.ms_deform_attn_cuda.launches == before
    with pytest.raises(ValueError, match="spatial shapes"):
        ms_deform_attn(t(value), ((4, 5),), t(loc), t(w))

