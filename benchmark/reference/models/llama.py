"""LLaMA decoder with interleaved gated MMFS cross-attention (counterpart
of `mm_interleaved_tpu/models/llama.py`).

  * every ``cross_attention_frequency``-th layer (idx % freq == 0) gains a
    tanh-gated MMFS block, its gate initialised at zero;
  * a preallocated `KVCache` with a ``valid`` mask and a ``length`` counter,
    written in place (the JAX cache is functional); beam search tiles it
    along batch and reorders it into a second buffer;
  * fp32 softmax attention, GQA, and left-padded positions;
  * tensor parallelism (`parallel.tensor`): the head counts come from the
    projections' widths, which a cut makes this rank's, and a row-parallel
    output is summed over the module's ``tensor_group`` (None: whole); the
    embedding and the text head are cut by vocabulary row.

The stack is one unrolled list of layers; the JAX ``scan_layers`` layout
is unstacked by the weight bridge (`utils/from_flax.py`), and
``scan_layers`` stays in the config for parity with the JAX presets.  With
``remat``, each decoder layer (its MMFS cross-attention included) is
recomputed in the backward of a call that autograd records.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.rmsnorm import rms_norm
from ..ops.rotary import apply_rotary_embedding, rotary_cos_sin
from ..parallel.tensor import (tensor_all_gather, tensor_all_reduce,
                               tensor_enter)
from .mmfs import MMFS
from .remat import remat_call


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32002
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    cross_attention_frequency: int = 4
    image_embed_dim: int = 1024
    spatial_shapes: Tuple[int, ...] = (32, 16, 8)
    mmfs_heads: int = 16
    mmfs_points: int = 8
    max_num_image_per_seq: int = 50
    dtype: str = "float32"
    remat: bool = False
    scan_layers: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((s, s) for s in self.spatial_shapes)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def has_cross_attn(self, layer_idx: int) -> bool:
        return layer_idx % self.cross_attention_frequency == 0


@dataclasses.dataclass
class KVCache:
    """Preallocated per-layer KV cache.

    ``k``/``v``: ``[n_layers, B, max_len, n_kv_heads, head_dim]``;
    ``valid``: ``[B, max_len]`` bool, which slots hold real tokens;
    ``length``: number of slots written so far (pad included).
    """

    k: torch.Tensor
    v: torch.Tensor
    valid: torch.Tensor
    length: int

    @classmethod
    def create(cls, config: LlamaConfig, batch: int, max_len: int,
               device=None, dtype: Optional[torch.dtype] = None,
               kv_heads: Optional[int] = None) -> "KVCache":
        """An empty cache; ``kv_heads`` is the model's own (`LlamaModel.
        kv_heads`: this rank's under tensor parallelism), default the
        config's."""
        shape = (config.num_hidden_layers, batch, max_len,
                 kv_heads or config.kv_heads, config.head_dim)
        dtype = dtype or config.compute_dtype
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            valid=torch.zeros((batch, max_len), dtype=torch.bool,
                              device=device),
            length=0,
        )

    def tile(self, k: int) -> "KVCache":
        """Each batch row repeated ``k`` times in place (``[B] -> [B*k]``,
        row ``b`` at ``b*k .. b*k+k-1``): the prefill's cache for ``k``
        beams."""
        return KVCache(
            k=self.k.repeat_interleave(k, dim=1),
            v=self.v.repeat_interleave(k, dim=1),
            valid=self.valid.repeat_interleave(k, dim=0),
            length=self.length,
        )

    def reorder(self, beam_idx: torch.Tensor, out: "KVCache") -> "KVCache":
        """Rows gathered along batch (the `_reorder_cache` of beam search)
        into ``out``'s buffers (same shapes), so that a beam step allocates
        nothing: the caller swaps the two caches."""
        torch.index_select(self.k, 1, beam_idx, out=out.k)
        torch.index_select(self.v, 1, beam_idx, out=out.v)
        torch.index_select(self.valid, 0, beam_idx, out=out.valid)
        out.length = self.length
        return out


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def init_weights(self, g: torch.Generator) -> None:
        self.weight.data.fill_(1.0)

    def forward(self, x):
        return rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)
        self.tensor_group = None

    def tensor_pairs(self):
        return (("tensor_group", self.gate_proj.out_features,
                 ("gate_proj", "up_proj", "down_proj")),)

    def forward(self, x):
        x = tensor_enter(x, self.tensor_group)
        return tensor_all_reduce(
            self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)),
            self.tensor_group)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        c = cfg.hidden_size
        self.q_proj = nn.Linear(c, cfg.num_attention_heads * hd, bias=False)
        self.k_proj = nn.Linear(c, cfg.kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(c, cfg.kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, c, bias=False)
        self.tensor_group = None

    def tensor_pairs(self):
        return (("tensor_group", self.n_kv,
                 ("q_proj", "k_proj", "v_proj", "o_proj")),)

    @property
    def n_q(self) -> int:
        """The query heads this module holds (all, or this rank's)."""
        return self.q_proj.out_features // self.cfg.head_dim

    @property
    def n_kv(self) -> int:
        return self.k_proj.out_features // self.cfg.head_dim

    def forward(self, x, positions, rope, attn_mask,
                cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_length: int = 0, causal: bool = False,
                segment_ids: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, T, _ = x.shape
        n_q, n_kv, hd = self.n_q, self.n_kv, cfg.head_dim
        x = tensor_enter(x, self.tensor_group)
        q = self.q_proj(x).view(B, T, n_q, hd)
        k = self.k_proj(x).view(B, T, n_kv, hd)
        v = self.v_proj(x).view(B, T, n_kv, hd)
        q, k = apply_rotary_embedding(q, k, rope[0], rope[1], positions)

        if cache_kv is not None:
            ck, cv = cache_kv  # [B, max_len, n_kv, hd], written in place
            ck[:, cache_length:cache_length + T] = k.to(ck.dtype)
            cv[:, cache_length:cache_length + T] = v.to(cv.dtype)
            k, v = ck, cv
        if n_kv != n_q:
            rep = n_q // n_kv
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)

        out = dot_product_attention(
            q, k, v, mask=attn_mask, causal=causal,
            q_segment_ids=segment_ids, kv_segment_ids=segment_ids,
        )
        return tensor_all_reduce(self.o_proj(out.reshape(B, T, n_q * hd)),
                                 self.tensor_group)


class LlamaMMFSCrossAttention(nn.Module):
    """Gated MMFS cross-attention: every token against all visible image
    pyramids from the fixed (0.5, 0.5) reference point, scaled by
    ``tanh(gate)``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.norm1 = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.norm2 = RMSNorm(cfg.image_embed_dim, cfg.rms_norm_eps)
        self.attn = MMFS(
            d_model=cfg.hidden_size,
            d_query=cfg.hidden_size,
            d_value=cfg.image_embed_dim,
            d_out=cfg.hidden_size,
            n_heads=cfg.mmfs_heads,
            n_points=cfg.mmfs_points,
            ratio=cfg.image_embed_dim / cfg.hidden_size,
            offset_init_magnitude=3.0,
            level_shapes=cfg.level_shapes,
            base_spatial_shape=(cfg.spatial_shapes[0]
                                if len(cfg.spatial_shapes) == 1 else 16),
            max_num_image_per_seq=cfg.max_num_image_per_seq,
        )
        self.gate = nn.Parameter(torch.empty(1))

    def init_weights(self, g: torch.Generator) -> None:
        self.gate.data.zero_()

    def forward(self, x, vision_hidden_states, cross_attention_mask,
                vision_value=None):
        h = self.norm1(x)
        vis = None
        if vision_value is None:
            vis = self.norm2(vision_hidden_states)
        out, value = self.attn(h, vis, cross_attention_mask,
                               projected_value=vision_value)
        return out * torch.tanh(self.gate.float()).to(out.dtype), value


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.has_cross = cfg.has_cross_attn(layer_idx)
        if self.has_cross:
            self.llama_cross_attn = LlamaMMFSCrossAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, rope, attn_mask, vision_hidden_states=None,
                cross_attention_mask=None, cache_kv=None, cache_length=0,
                causal=False, segment_ids=None, vision_value=None):
        """Returns (hidden, MMFS projected value or None)."""
        h = self.self_attn(self.input_layernorm(x), positions, rope, attn_mask,
                           cache_kv, cache_length, causal, segment_ids)
        x = x + h
        value = None
        if self.has_cross and (vision_hidden_states is not None
                               or vision_value is not None):
            h, value = self.llama_cross_attn(
                x, vision_hidden_states, cross_attention_mask,
                vision_value=vision_value,
            )
            x = x + h
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, value


def build_positions(attention_mask: torch.Tensor,
                    prev_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Position = number of valid tokens strictly before each slot (HF's
    ``cumsum(mask) - 1`` convention for left-padded batches)."""
    m = attention_mask.long()
    pos = torch.cumsum(m, dim=-1) - m
    if prev_valid is not None:
        pos = pos + prev_valid[:, None]
    return pos.clamp(min=0)


class LlamaModel(nn.Module):
    """Decoder stack over ``inputs_embeds``; returns final hidden states."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers)]
        )
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.tensor_group = None

    def init_weights(self, g: torch.Generator) -> None:
        self.embed_tokens.weight.data.normal_(0.0, 0.02, generator=g)

    def tensor_pairs(self):
        return (("tensor_group", self.embed_tokens.num_embeddings,
                 ("embed_tokens",)),)

    @property
    def kv_heads(self) -> int:
        """The key/value heads a layer holds (all, or this rank's)."""
        return self.layers[0].self_attn.n_kv

    def embed(self, text_ids: torch.Tensor) -> torch.Tensor:
        """The embeddings of ``text_ids``; cut by row over ``tensor``, each
        rank looks up the ids it holds, zeroes the others' rows and the
        ranks' rows are summed (exact: one rank holds each id)."""
        group = self.tensor_group
        if group is None:
            return self.embed_tokens(text_ids)
        import torch.distributed as dist

        rows = self.embed_tokens.num_embeddings
        local = text_ids - dist.get_rank(group) * rows
        mine = (local >= 0) & (local < rows)
        out = self.embed_tokens(torch.where(mine, local, 0))
        return tensor_all_reduce(out.masked_fill(~mine[..., None], 0), group)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # [B, T, C]
        attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1 = valid
        vision_hidden_states: Optional[torch.Tensor] = None,
        cross_attention_mask: Optional[torch.Tensor] = None,  # [B, T, n_img]
        cache: Optional[KVCache] = None,
        positions: Optional[torch.Tensor] = None,
        vision_value_cache: Optional[List[torch.Tensor]] = None,
    ):
        """Returns ``(hidden, cache, vision_values)``: ``cache`` is updated
        in place; ``vision_values`` lists the MMFS value projections of the
        cross layers, in layer order (empty without vision input), for
        ``vision_value_cache`` on later steps."""
        cfg = self.config
        B, T, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if attention_mask is None:
            attention_mask = torch.ones((B, T), dtype=torch.int32, device=dev)

        if cache is None:
            if positions is None:
                positions = build_positions(attention_mask)
            attn_mask = None
            segment_ids = attention_mask.int()
            causal = True
            cache_length = 0
        else:
            max_len = cache.k.shape[2]
            prev_valid = cache.valid.sum(dim=-1)
            if positions is None:
                positions = build_positions(attention_mask, prev_valid)
            cache_length = cache.length
            cache.valid[:, cache_length:cache_length + T] = attention_mask.bool()
            slot = torch.arange(max_len, device=dev)[None, None, :]
            qi = cache_length + torch.arange(T, device=dev)[None, :, None]
            attn_mask = (slot <= qi)[:, None] & cache.valid[:, None, None, :]
            segment_ids = None
            causal = False

        rope = rotary_cos_sin(cfg.head_dim, cfg.max_position_embeddings,
                              base=cfg.rope_theta, device=dev)
        h = inputs_embeds.to(self.norm.weight.dtype)
        vision_values = []
        for i, layer in enumerate(self.layers):
            cache_kv = None if cache is None else (cache.k[i], cache.v[i])
            vision_value = None
            if vision_value_cache is not None and cfg.has_cross_attn(i):
                vision_value = vision_value_cache[
                    i // cfg.cross_attention_frequency
                ]
            h, value = remat_call(
                cfg.remat, layer,
                h, positions, rope, attn_mask, vision_hidden_states,
                cross_attention_mask, cache_kv, cache_length, causal,
                segment_ids, vision_value,
            )
            if value is not None:
                vision_values.append(value)
        if cache is not None:
            cache.length += T
        return self.norm(h), cache, vision_values


class TextDecoder(nn.Module):
    """Dual-head text decoder: ``head`` over the full vocabulary (new-vocab
    bias -100) plus ``head_new`` over the new special-token slots (zero
    weight, bias 95, so -5 net at init).  Cut over ``tensor``, ``head``
    holds this rank's rows of the vocabulary and its logits are gathered;
    ``head_new`` stays whole."""

    def __init__(self, cfg: LlamaConfig, orig_vocab_size: int = 32000):
        super().__init__()
        self.orig_vocab_size = orig_vocab_size
        self.head = nn.Linear(cfg.hidden_size, cfg.vocab_size)
        self.head_new = nn.Linear(cfg.hidden_size,
                                  cfg.vocab_size - orig_vocab_size)
        self.tensor_group = None

    def tensor_pairs(self):
        return (("tensor_group", self.head.out_features, ("head",)),)

    def init_weights(self, g: torch.Generator) -> None:
        self.head.bias.data.zero_()
        self.head.bias.data[self.orig_vocab_size:] = -100.0
        self.head_new.weight.data.zero_()
        self.head_new.bias.data.fill_(95.0)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        group = self.tensor_group
        logits = tensor_all_gather(
            self.head(tensor_enter(hidden_states, group)), group)
        new = self.head_new(hidden_states)
        return torch.cat(
            [logits[..., :self.orig_vocab_size],
             logits[..., self.orig_vocab_size:] + new], dim=-1
        )
