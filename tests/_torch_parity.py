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
import torch

from mm_interleaved_tpu.configs import tiny_config
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved


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
