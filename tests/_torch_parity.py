"""Shared fixtures for the JAX-vs-PyTorch parity tests (tests/test_torch_*.py).

Every test holds a `mm_interleaved_tpu` module against its counterpart in
`mm_interleaved_tpu_torch` on the same weights and inputs: a JAX init whose
every leaf is replaced by seeded noise (many leaves initialise at zero and
would hide whole branches), carried over by `utils.from_flax`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.configs import tiny_config
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved


@pytest.fixture(scope="module", autouse=True)
def one_native_build():
    """The JAX package's image kernels from the port's build of the same
    source (`mm_interleaved_tpu_torch/data/native.py`), for the module that
    imports this fixture.  The JAX package builds `native/mmi_native.cpp`
    with ``-march=native``, whose FMAs round the resampler differently from
    one host and compiler to the next; the port builds it with IEEE
    arithmetic only (ROADMAP.md §3).  The pipelines are held to each other
    bit for bit on one build."""
    from mm_interleaved_tpu.data import native as j_native
    from mm_interleaved_tpu_torch.data import native as t_native

    saved = j_native._build_and_load
    j_native._build_and_load = t_native._build_and_load
    yield
    j_native._build_and_load = saved


def noised(params, seed: int = 1):
    """Replace every leaf with seeded noise at a scale fit for its role:
    norms around 1, kernels fan-in scaled, everything else 0.3 * N(0, 1)."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        x = np.asarray(x)
        if name == "scale" or (name == "weight" and x.ndim == 1):
            return (1.0 + 0.1 * rs.randn(*x.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(x.shape[:-1]) if x.ndim == 4 else x.shape[-2]
            return (rs.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rs.randn(*x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def tiny_batch(cfg, n_img_row=(1, 1), L: int = 16, seed: int = 0):
    """The left-padded two-row prompt of tests/test_generation.py."""
    S = cfg.special
    rng = np.random.RandomState(seed)
    row = [S.bos_token_id, 5, S.soi_token_id] + \
        [S.image_token_id] * cfg.num_img_token + [7, 8]
    pad = L - len(row)
    ids = np.array(
        [[S.pad_token_id] * pad + row,
         [S.pad_token_id] * (pad + 1) + row[:-1]], dtype=np.int32,
    )
    att = (ids != S.pad_token_id).astype(np.int32)
    att[0, :pad] = 0
    att[1, :pad + 1] = 0
    size = cfg.visual.encoder.vit.image_size
    imgs = rng.rand(2, cfg.max_num_images, size, size, 3).astype(np.float32)
    return dict(text_ids=ids, image_tensors=imgs,
                num_image_per_seq=np.array(n_img_row, np.int32),
                attention_mask=att)


def interleaved_batch(cfg, L=40, max_img=3, seed=0):
    """Two rows of interleaved documents with images (row 1 holds two images
    in one document, so one target image has a previous image), the image
    targets of the image decoder, padding at the end."""
    S = cfg.special
    n_tok = cfg.num_img_token

    def row(docs):
        r = []
        for doc in docs:
            r.append(S.bos_token_id)
            for x in doc:
                r += ([S.soi_token_id] + [S.image_token_id] * n_tok
                      if x == "I" else [x])
            r.append(S.eos_token_id)
        return r + [S.pad_token_id] * (L - len(r))

    rng = np.random.RandomState(seed)
    ids = np.array([row([[5, 6, "I", 7], [8, "I", 9, 10]]),
                    row([[11, "I", 12, "I", 13, 14]])], np.int32)
    return dict(
        text_ids=ids,
        image_tensors=rng.rand(2, max_img, 56, 56, 3).astype(np.float32),
        num_image_per_seq=np.array([2, 2], np.int32),
        attention_mask=(ids != S.pad_token_id).astype(np.int32),
        image_tensors_dec=rng.rand(2, max_img, 16, 16, 3).astype(np.float32),
    )


def init_tiny(scan_layers: bool, seed: int = 1):
    """(config, JAX model, noised params as numpy, batch)."""
    cfg = tiny_config(with_image_decoder=False, scan_layers=scan_layers)
    model = MMInterleaved(cfg)
    batch = tiny_batch(cfg)
    params = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0)},
        jnp.asarray(batch["text_ids"]), jnp.asarray(batch["image_tensors"]),
        jnp.asarray(batch["num_image_per_seq"]),
    )
    return cfg, model, noised(params, seed), batch


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# Lengths that straddle the Hopper kernels' 64- and 128-row tiles, and the
# masks that leave a row or a whole query tile without a key:
# name: (Tq, Tk, causal, segments)
FLASH_EDGES = {
    "straddle_cross": (200, 77, False, None),
    "straddle_self": (257, 257, False, None),
    "causal_tq_lt_tk": (100, 300, True, None),
    "dead_segment_rows": (130, 150, False, "dead"),
    "causal_rows_before_keys": (300, 100, True, None),
}


def flash_edge_case(case, D, rs):
    """q, k, v, dout and the mask keywords of a `FLASH_EDGES` case (H = 2):
    "dead" gives the first 7 queries of every row a segment no key has."""
    Tq, Tk, causal, seg = FLASH_EDGES[case]
    B, H = 2, 2
    q, k, v, dout = (rs.randn(B, T, H, D).astype(np.float32)
                     for T in (Tq, Tk, Tk, Tq))
    kw = dict(causal=causal) if causal else {}
    if seg == "dead":
        qs = np.sort(rs.randint(0, 3, (B, Tq)), 1).astype(np.int32)
        ks = np.sort(rs.randint(0, 3, (B, Tk)), 1).astype(np.int32)
        qs[:, :7] = 9
        kw.update(q_segment_ids=qs, kv_segment_ids=ks)
    return q, k, v, dout, kw


def mi_inputs(level_shapes, Lq, n_img, Bv, B, seed):
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
