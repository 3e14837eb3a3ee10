"""HF checkpoints -> the port's parameters (counterpart of
`mm_interleaved_tpu/utils/convert_hf.py`).

Each converter returns a `name_map.NameMap` keyed by the port's parameter
names (what `utils.from_flax.port_name` gives the JAX converter's paths).
The source is torch like the port, so Linear weights stay ``[out, in]``
and convolutions OIHW; the JAX converters' transposes have no counterpart.
"""

from __future__ import annotations

from typing import Collection, Optional

import torch

from .name_map import Entry, NameMap, const, flat, prefixed, same
from .state_dict_io import pad_rows

# the MMFS module's Linear layers (reference models/utils/ops/modules/
# mmfs.py:86-99)
MMFS_LINEARS = ("sampling_offsets", "dynamic_offset_mask",
                "attention_weights", "value_proj", "output_proj")
# the buffers old HF LLaMA checkpoints keep (recomputed by the port's rotary)
LLAMA_SKIPS = (r"(^|\.)rotary_emb\.inv_freq$",)
# what a CLIP checkpoint holds beside the vision tower's core: the text
# tower and the projections (a full `CLIPModel`), the vision tower's post
# layernorm and the position-id buffers
CLIP_VISION_SKIPS = (r"^text_model\.", r"^text_projection\.", r"^logit_scale$",
                     r"^visual_projection\.", r"(^|\.)post_layernorm\.",
                     r"(^|\.)position_ids$")


def convert_mmfs(prefix: str) -> NameMap:
    """Reference `MMFS` module -> the port's `MMFS` (relative names); its
    ``ignore_token`` is stored ``[1, 1, 1, C]``."""
    nmap: NameMap = {}
    for name in MMFS_LINEARS:
        nmap[f"{name}.weight"] = same(f"{prefix}{name}.weight")
        nmap[f"{name}.bias"] = same(f"{prefix}{name}.bias")
    nmap["ignore_token"] = flat(f"{prefix}ignore_token", 3)
    nmap["query_relpos.weight"] = same(f"{prefix}query_relpos.weight")
    return nmap


def convert_llama(num_layers: int, prefix: str = "model.",
                  mmfs_layers: Collection[int] = ()) -> NameMap:
    """HF `LlamaModel` -> the port's `LlamaModel` (relative names).  The
    layers of ``mmfs_layers`` carry the reference's ``llama_cross_attn``
    MMFS block (modeling_llama_mmfs.py:311-367): gate, norm1/norm2 and the
    inner MMFS module."""
    nmap: NameMap = {"embed_tokens.weight": same(f"{prefix}embed_tokens.weight")}
    for i in range(num_layers):
        lp = f"{prefix}layers.{i}."
        layer: NameMap = {}
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            layer[f"self_attn.{name}.weight"] = same(f"{lp}self_attn.{name}.weight")
        for name in ("gate_proj", "up_proj", "down_proj"):
            layer[f"mlp.{name}.weight"] = same(f"{lp}mlp.{name}.weight")
        for name in ("input_layernorm", "post_attention_layernorm"):
            layer[f"{name}.weight"] = same(f"{lp}{name}.weight")
        if i in mmfs_layers:
            x = f"{lp}llama_cross_attn."
            layer["llama_cross_attn.gate"] = same(f"{x}gate")
            for name in ("norm1", "norm2"):
                layer[f"llama_cross_attn.{name}.weight"] = same(f"{x}{name}.weight")
            layer.update(prefixed("llama_cross_attn.attn.",
                                  convert_mmfs(f"{x}attn.")))
        nmap.update(prefixed(f"layers.{i}.", layer))
    nmap["norm.weight"] = same(f"{prefix}norm.weight")
    return nmap


def padded_embedding(key: str, rows: int, source_rows: int) -> Entry:
    """An HF embedding of ``source_rows`` rows padded to ``rows`` with the
    mean embedding (the tower assembly's vocabulary resize)."""
    return Entry((key,), lambda w: pad_rows(w, rows),
                 lambda shape: (source_rows,) + tuple(shape[1:]))


def _head_rows(vocab_size: int, orig_vocab_size: int):
    def fn(w: torch.Tensor) -> torch.Tensor:
        out = w.new_zeros((vocab_size, w.shape[1]))
        n = min(orig_vocab_size, w.shape[0])
        out[:n] = w[:n]
        return out
    return fn


def convert_text_decoder(vocab_size: int, orig_vocab_size: int, hidden: int,
                         lm_head_rows: Optional[int] = None) -> NameMap:
    """The dual-head TextDecoder built from the LLM's ``lm_head``
    (reference decoder_text.py:53-91): the frozen ``head`` takes the
    lm_head's rows of the original vocabulary (its new rows zero, bias
    -100); ``head_new`` is a zero kernel with bias 95 (relative names)."""
    n_new = vocab_size - orig_vocab_size

    def head_bias():
        b = torch.zeros(vocab_size)
        b[orig_vocab_size:] = -100.0
        return b

    rows = orig_vocab_size if lm_head_rows is None else lm_head_rows
    return {
        "head.weight": Entry(("lm_head.weight",),
                             _head_rows(vocab_size, orig_vocab_size),
                             lambda shape: (rows, hidden)),
        "head.bias": const(head_bias),
        "head_new.weight": const(lambda: torch.zeros(n_new, hidden)),
        "head_new.bias": const(lambda: torch.full((n_new,), 95.0)),
    }


def convert_clip_vit(num_layers: int, prefix: str = "vision_model.") -> NameMap:
    """HF `CLIPVisionModel` -> the port's ViT core (embeddings,
    pre_layrnorm, layers; relative names): the visual tokenizer's encoder,
    or a CLIP vision tower."""
    e = f"{prefix}embeddings."
    nmap: NameMap = {
        "embeddings.patch_embedding.weight": same(f"{e}patch_embedding.weight"),
        "embeddings.class_embedding": same(f"{e}class_embedding"),
        "embeddings.position_embedding": same(f"{e}position_embedding.weight"),
        "pre_layrnorm.weight": same(f"{prefix}pre_layrnorm.weight"),
        "pre_layrnorm.bias": same(f"{prefix}pre_layrnorm.bias"),
    }
    nmap.update(clip_layers(num_layers, f"{prefix}encoder.layers."))
    return nmap


def clip_layers(num_layers: int, prefix: str) -> NameMap:
    """HF CLIP encoder layers (vision or text) -> the port's `ViTLayer`s."""
    nmap: NameMap = {}
    for i in range(num_layers):
        lp = f"{prefix}{i}."
        for ours, theirs in (("q_proj", "self_attn.q_proj"),
                             ("k_proj", "self_attn.k_proj"),
                             ("v_proj", "self_attn.v_proj"),
                             ("out_proj", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"),
                             ("layer_norm1", "layer_norm1"),
                             ("layer_norm2", "layer_norm2")):
            for leaf in ("weight", "bias"):
                nmap[f"layers.{i}.{ours}.{leaf}"] = same(f"{lp}{theirs}.{leaf}")
    return nmap
