"""Perceiver resampler, a query-only BLIP-2 Q-Former (counterpart of
`mm_interleaved_tpu/models/perceiver.py`): post-LN blocks over learned
queries with self-attention, cross-attention every
``cross_attention_frequency`` layers (from layer 0), an erf-GELU FFN, and
optional q/k LayerNorm over ``head_dim``.  An ``encoder_attention_mask
[B, S]`` masks the cross-attention keys (a dense mask: that call stays on
the plain attention path; the mask-free self-attention takes the flash
kernel on the card).  In training mode, ``dropout`` applies where the JAX
module's ``nn.Dropout`` does (the input, each attention output, the FFN
output), its keep masks drawn from the ``generator`` of the call."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: in training, keep each element with
    probability ``1 - rate`` (the mask drawn from ``generator``) and scale
    the kept ones by ``1 / (1 - rate)``; otherwise ``x``."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class PerceiverConfig:
    num_queries: int = 64
    hidden_size: int = 768
    encoder_hidden_size: int = 1024
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    cross_attention_frequency: int = 2
    intermediate_size: Optional[int] = None
    qk_normalization: bool = False
    layer_norm_eps: float = 1e-12
    dropout: float = 0.0
    initializer_range: float = 0.02
    dtype: str = "float32"

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class _MHA(nn.Module):
    def __init__(self, cfg: PerceiverConfig, kv_dim: int):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        hd = c // cfg.num_attention_heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(kv_dim, c)
        self.value = nn.Linear(kv_dim, c)
        if cfg.qk_normalization:
            self.q_norm = nn.LayerNorm(hd, eps=cfg.layer_norm_eps)
            self.k_norm = nn.LayerNorm(hd, eps=cfg.layer_norm_eps)
        self.output = nn.Linear(c, c)

    def forward(self, x, kv, kv_mask=None, generator=None):
        c = self.cfg
        B, T, _ = x.shape
        S = kv.shape[1]
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        q = self.query(x).view(B, T, nh, hd)
        k = self.key(kv).view(B, S, nh, hd)
        v = self.value(kv).view(B, S, nh, hd)
        if c.qk_normalization:
            q = self.q_norm(q)
            k = self.k_norm(k)
        mask = None if kv_mask is None else kv_mask[:, None, None, :].bool()
        out = dot_product_attention(q, k, v, mask=mask)
        out = self.output(out.reshape(B, T, c.hidden_size))
        return dropout(out, c.dropout, self.training, generator)


class PerceiverLayer(nn.Module):
    def __init__(self, cfg: PerceiverConfig, has_cross: bool):
        super().__init__()
        c = cfg.hidden_size
        eps = cfg.layer_norm_eps
        self.attention = _MHA(cfg, c)
        self.attention_norm = nn.LayerNorm(c, eps=eps)
        self.has_cross = has_cross
        self.rate = cfg.dropout
        if has_cross:
            self.crossattention = _MHA(cfg, cfg.encoder_hidden_size)
            self.crossattention_norm = nn.LayerNorm(c, eps=eps)
        self.intermediate = nn.Linear(c, cfg.ffn_size)
        self.ffn_output = nn.Linear(cfg.ffn_size, c)
        self.output_norm = nn.LayerNorm(c, eps=eps)

    def forward(self, x, enc, enc_mask=None, generator=None):
        x = self.attention_norm(x + self.attention(x, x, generator=generator))
        if self.has_cross:
            x = self.crossattention_norm(
                x + self.crossattention(x, enc, enc_mask, generator))
        h = self.ffn_output(F.gelu(self.intermediate(x)))
        h = dropout(h, self.rate, self.training, generator)
        return self.output_norm(x + h)


class PerceiverResampler(nn.Module):
    def __init__(self, cfg: PerceiverConfig):
        super().__init__()
        self.cfg = cfg
        self.queries = nn.Parameter(
            torch.empty(1, cfg.num_queries, cfg.hidden_size)
        )
        self.input_norm = nn.LayerNorm(cfg.hidden_size,
                                       eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([
            PerceiverLayer(cfg, has_cross=(i % cfg.cross_attention_frequency
                                           == 0))
            for i in range(cfg.num_hidden_layers)
        ])

    def init_weights(self, g: torch.Generator) -> None:
        self.queries.data.normal_(0.0, self.cfg.initializer_range, generator=g)

    def forward(self, encoder_hidden_states: torch.Tensor,
                encoder_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        B = encoder_hidden_states.shape[0]
        x = self.input_norm(self.queries.expand(B, -1, -1))
        x = dropout(x, self.cfg.dropout, self.training, generator)
        for layer in self.layers:
            x = layer(x, encoder_hidden_states, encoder_attention_mask,
                      generator)
        return x
