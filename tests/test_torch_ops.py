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



# --- the image slice's kernels: plain versions against JAX ----------------

from mm_interleaved_tpu.ops.geglu import geglu_mlp as j_geglu
from mm_interleaved_tpu.ops.group_norm import (
    group_norm as j_gn, group_norm_silu as j_gn_silu,
)
from mm_interleaved_tpu.ops.ms_deform_attn_pallas_mi import (
    mmfs_deform_factorized as j_mi,
    mmfs_deform_factorized_prepared as j_mi_prepared,
    prepare_image_side as j_image_side,
)
from mm_interleaved_tpu_torch.ops import flash_attention as fa
from mm_interleaved_tpu_torch.ops import geglu as tgeglu
from mm_interleaved_tpu_torch.ops import group_norm as tgn
from mm_interleaved_tpu_torch.ops import ms_deform_attn_mi as tmi


def _mi_inputs(level_shapes, Lq, n_img, Bv, B, seed):
    """The inputs of tests/test_pallas_kernel.py's factorised-kernel tests,
    with the last image masked out through its weight factor and offsets
    large enough to leave the grid."""
    rng = np.random.RandomState(seed)
    H, P, D = 4, 3, 8
    L = len(level_shapes)
    hw = sum(h * w for h, w in level_shapes)
    value = rng.randn(Bv, n_img, hw, H, D).astype(np.float32)
    off_img = (rng.randn(Bv, n_img, H, P, 2) * 2).astype(np.float32)
    wi = rng.rand(Bv, n_img, H, L, P).astype(np.float32)
    wi[:, -1] = 0.0
    ref = rng.rand(B, Lq, 2).astype(np.float32)
    off_q = (rng.randn(B, Lq, H, P, 2) * 2).astype(np.float32)
    wq = rng.rand(B, Lq, H, L, P).astype(np.float32)
    return value, off_img, wi, ref, off_q, wq


@pytest.mark.parametrize(
    "level_shapes,Lq,n_img",
    [(((8, 8), (4, 4)), 70, 2), (((16, 16), (8, 8), (4, 4), (2, 2)), 128, 3)],
)
def test_mi_plain_matches_factorized_kernel_interpret(level_shapes, Lq,
                                                      n_img):
    """Plain factorised readout against the Pallas kernel in interpret
    mode (atol 1e-5: the same sums in another order)."""
    value, off_img, wi, ref, off_q, wq = _mi_inputs(level_shapes, Lq, n_img,
                                                    2, 2, 3)
    base = level_shapes[0][0]
    want = j_mi(jnp.asarray(value), level_shapes, jnp.asarray(ref),
                jnp.asarray(off_q), jnp.asarray(off_img), jnp.asarray(wq),
                jnp.asarray(wi), inv_base=1.0 / base, interpret=True)
    delta = tmi.build_delta(t(off_img), t(wi), level_shapes, 1.0 / base)
    before = tmi.ms_deform_attn_mi_cuda.launches
    got = tmi.mmfs_deform_factorized(t(value), delta, level_shapes, t(ref),
                                     t(off_q), t(wq), 1.0 / base)
    assert tmi.ms_deform_attn_mi_cuda.launches == before  # CPU: plain path
    close(got, want, 0, 1e-5)


def test_mi_plain_cfg_shared_image_side():
    """A half-batch image side (query row c*Bv + b reads image row b)
    against `mmfs_deform_factorized_prepared` on the same layout."""
    shapes = ((8, 8), (4, 4))
    value, off_img, wi, ref, off_q, wq = _mi_inputs(shapes, 70, 2, 2, 4, 7)
    level_vals, jdelta = j_image_side(jnp.asarray(value), shapes,
                                      jnp.asarray(off_img), jnp.asarray(wi),
                                      1.0 / 8)
    want = j_mi_prepared(level_vals, jdelta, shapes, jnp.asarray(ref),
                         jnp.asarray(off_q), jnp.asarray(wq), inv_base=1.0 / 8,
                         interpret=True)
    delta = tmi.build_delta(t(off_img), t(wi), shapes, 1.0 / 8)
    close(delta, jdelta, 0, 1e-6)
    got = tmi.ms_deform_attn_mi_plain(t(value), delta, shapes, t(ref),
                                      t(off_q), t(wq), 1.0 / 8)
    close(got, want, 0, 1e-5)


@pytest.mark.parametrize("case,D", [
    ("plain", 8), ("plain", 64), ("causal_segments", 8),
    ("causal_segments", 64), ("cross", 8), ("cross", 64), ("scale", 16),
])
def test_flash_plain_matches_jax_attention(case, D):
    """The kernel's plain version against JAX `dot_product_attention` on
    the CPU (its XLA path): non-causal; causal with left-padding segment
    ids; Tq != Tk; an explicit scale.  atol 1e-5."""
    rs = np.random.RandomState(D)
    B, H = 2, 3
    Tq, Tk = (5, 9) if case == "cross" else (11, 11)
    q, k, v = (rs.randn(B, T, H, D).astype(np.float32)
               for T in (Tq, Tk, Tk))
    kw = {}
    if case == "causal_segments":
        seg = np.ones((B, Tq), np.int32)
        seg[1, :4] = 0  # row 1 is left-padded by 4
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    if case == "scale":
        kw = dict(scale=0.3)
    want = jatt.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{a: jnp.asarray(b) if isinstance(b, np.ndarray) else b
           for a, b in kw.items()})
    got = dot_product_attention(
        t(q), t(k), t(v),
        **{a: t(b) if isinstance(b, np.ndarray) else b
           for a, b in kw.items()})
    close(got, want, 0, 1e-5)
    close(fa.attention_plain(t(q), t(k), t(v), **{
        a: t(b) if isinstance(b, np.ndarray) else b for a, b in kw.items()}),
        want, 0, 1e-5)


@pytest.mark.parametrize("eps,shape,G", [
    (1e-5, (2, 8, 8, 32), 4),  # UNet ResnetBlock
    (1e-6, (2, 16, 16, 16), 4),  # VAE
    (1e-6, (2, 4, 4, 24), 8),  # SpatialTransformer, C not a power of 2
])
def test_group_norm_and_silu_match_jax(eps, shape, G):
    rs = np.random.RandomState(1)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    args_j = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), G, eps)
    args_t = (t(x), t(scale), t(bias), G, eps)
    close(tgn.group_norm(*args_t), j_gn(*args_j), 0, 1e-5)
    before = tgn.group_norm_silu_apply_cuda.launches
    close(tgn.group_norm_silu(*args_t), j_gn_silu(*args_j), 0, 1e-5)
    assert tgn.group_norm_silu_apply_cuda.launches == before


@pytest.mark.parametrize("B,T,C", [(2, 32, 16), (1, 64, 32)])
def test_geglu_plain_matches_pallas_interpret(B, T, C):
    """The plain fused feed-forward against the Pallas kernel in interpret
    mode (its tiling needs T % 512 == 0, so T pads to the tile there).
    rtol 1e-5."""
    rs = np.random.RandomState(0)
    x = rs.randn(B, 512, C).astype(np.float32)
    w1 = (rs.randn(C, 8 * C) / np.sqrt(C)).astype(np.float32)
    b1 = (0.1 * rs.randn(8 * C)).astype(np.float32)
    w2 = (rs.randn(4 * C, C) / np.sqrt(4 * C)).astype(np.float32)
    b2 = (0.1 * rs.randn(C)).astype(np.float32)
    want = np.asarray(j_geglu(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)),
                              interpret=True))[:, :T]
    got = tgeglu.geglu_mlp(t(x[:, :T]), t(w1.T.copy()), t(b1),
                           t(w2.T.copy()), t(b2))
    close(got, want, 1e-5, 1e-6)


def test_new_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    """Each kernel wrapper raises on CPU tensors and does not count."""
    x = torch.zeros(1, 4, 4, 8)
    calls = [
        (fa.flash_attention, (x, x, x)),
        (tgn.group_norm_silu_apply_cuda,
         (x, torch.zeros(1, 8), torch.zeros(1, 8))),
        (tgeglu.geglu_cuda, (torch.zeros(3, 8), torch.zeros(64, 8),
                             torch.zeros(64), torch.zeros(8, 32),
                             torch.zeros(8))),
        (tmi.ms_deform_attn_mi_cuda,
         (torch.zeros(1, 1, 16, 1, 8), torch.zeros(1, 1, 1, 3),
          ((4, 4),), torch.zeros(1, 2, 2), torch.zeros(1, 2, 1, 1, 2),
          torch.zeros(1, 2, 1, 1, 1), 0.25)),
        (fa.flash_attention_bwd, (x, x, x, x, torch.zeros(1, 4, 4))),
    ]
    value, loc, w = (torch.zeros(1, 16, 1, 8), torch.zeros(1, 3, 1, 1, 2, 2),
                     torch.zeros(1, 3, 1, 1, 2))
    for kernel in (kmod.ms_deform_attn_bwd_value_cuda,
                   kmod.ms_deform_attn_bwd_loc_weight_cuda):
        calls.append((kernel, (value, ((4, 4),), loc, w,
                               torch.zeros(1, 3, 8))))
    for kernel, args in calls:
        before = kernel.launches
        with pytest.raises(ValueError, match="CUDA"):
            kernel(*args)
        assert kernel.launches == before
