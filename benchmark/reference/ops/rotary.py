"""Rotary position embeddings, LLaMA half-rotation layout (counterpart of
`mm_interleaved_tpu/ops/rotary.py`)."""

from __future__ import annotations

import torch


def rotary_cos_sin(head_dim: int, max_len: int, base: float = 10000.0,
                   device=None):
    """(cos, sin) tables of shape ``[max_len, head_dim]`` in fp32."""
    inv_freq = 1.0 / (
        base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_embedding(q, k, cos, sin, positions):
    """q, k: ``[B, T, n_heads, head_dim]``; positions ``[B, T]`` int."""
    c = cos[positions][:, :, None, :].to(q.dtype)
    s = sin[positions][:, :, None, :].to(q.dtype)
    return q * c + _rotate_half(q) * s, k * c + _rotate_half(k) * s
