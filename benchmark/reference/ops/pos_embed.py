"""Sin-cos positional tables and image resizing with JAX's semantics
(counterpart of `mm_interleaved_tpu/ops/pos_embed.py`).

`jax.image.resize` is a separable scale-and-translate: per resized axis a
dense ``[out, in]`` weight matrix built from a triangle ("linear") or Keys
cubic (a = -0.5) kernel, widened by ``in/out`` when it shrinks
(antialiasing) and renormalised per output sample.  Torch's
``F.interpolate`` uses a = -0.75 and no antialiasing, so it differs; this
module rebuilds JAX's matrices in numpy and applies them as matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _sincos_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> np.ndarray:
    """``[length, embed_dim]`` fixed sin-cos table."""
    return _sincos_from_grid(embed_dim, np.arange(length, dtype=np.float32))


def get_2d_sincos_pos_embed(
    embed_dim: int, grid_size: int, cls_token: bool = False
) -> np.ndarray:
    """``[grid_size**2 (+1), embed_dim]``: the first half of the dim encodes
    H, the second W (the order matters for weight parity)."""
    assert embed_dim % 2 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    emb_h = _sincos_from_grid(embed_dim // 2, grid[1])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[0])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate(
            [np.zeros([1, embed_dim], dtype=np.float32), pos_embed], axis=0
        )
    return pos_embed


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int, method: str) -> np.ndarray:
    """``[out_size, in_size]`` fp32 matrix of `jax.image.resize` (antialias
    on) along one axis: ``out = W @ in``."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + 0.5) * inv_scale - 0.5
    x = np.abs(
        sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
    ) / kernel_scale
    w = _KERNELS[method](x).astype(np.float32)  # [in, out]
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def resize_nhwc(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """`jax.image.resize` of ``[B, H, W, C]`` to ``[B, *size, C]``, computed
    in fp32 and returned in the input dtype."""
    H, W = x.shape[1], x.shape[2]
    out = x.float()
    if size[0] != H:
        wh = torch.from_numpy(resize_weights(H, size[0], method)).to(x.device)
        out = torch.einsum("oh,bhwc->bowc", wh, out)
    if size[1] != W:
        ww = torch.from_numpy(resize_weights(W, size[1], method)).to(x.device)
        out = torch.einsum("ow,bhwc->bhoc", ww, out)
    return out.to(x.dtype)


def resize_abs_pos_embed(pos_embed: torch.Tensor, src_size: int,
                         tgt_size: int) -> torch.Tensor:
    """Cubic resize of a ``[src_size**2, C]`` grid table to
    ``[tgt_size**2, C]``."""
    if src_size == tgt_size:
        return pos_embed
    c = pos_embed.shape[-1]
    x = pos_embed.reshape(1, src_size, src_size, c)
    x = resize_nhwc(x, (tgt_size, tgt_size), "cubic")
    return x.reshape(tgt_size * tgt_size, c)


@functools.lru_cache(maxsize=None)
def resized_sincos_table(embed_dim: int, grid_size: int,
                         tgt_size: int) -> np.ndarray:
    """The 2D sin-cos table (no cls row) resized to ``tgt_size``, in numpy:
    a constant of the configuration."""
    table = torch.from_numpy(get_2d_sincos_pos_embed(embed_dim, grid_size))
    return resize_abs_pos_embed(table, grid_size, tgt_size).numpy()
