"""The CLIP towers of the text-image rerank (counterpart of
`mm_interleaved_tpu/models/clip_text.py`, and of the projected image side
of `mm_interleaved_tpu/utils/fid.py`'s ``CLIPViTFeatures``).

`CLIPTextModel` is the standard CLIP text transformer: token and learned
position embeddings, pre-LN blocks with causal attention
(`ops.attention.dot_product_attention`, so the flash kernel on the card),
the final LN, pooling at the first end-of-text token of each row (the last
position where a row has none) and the projection into the shared
image-text space.  `CLIPVisionTower` is HF's ``CLIPModel.get_image_features``:
the vision transformer's cls token through ``post_layernorm`` and
``visual_projection``.  `load_clip` builds both from one HF CLIP checkpoint
(``openai/clip-vit-large-patch14``), so the rerank compares features of one
space; the converters are name maps (`utils.name_map`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.convert_hf import clip_layers, convert_clip_vit
from ..utils.name_map import NameMap, check_coverage, prefixed, same, stream_into
from .vit import ViTConfig, ViTEmbeddings, ViTLayer


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    projection_dim: int = 512
    eos_token_id: int = 49407

    def layer_config(self) -> ViTConfig:
        """The `ViTLayer` config of one block."""
        return ViTConfig(hidden_size=self.hidden_size,
                         intermediate_size=self.intermediate_size,
                         num_attention_heads=self.num_attention_heads,
                         layer_norm_eps=self.layer_norm_eps,
                         hidden_act=self.hidden_act)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, c)
        self.position_embedding = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, c))
        layer = cfg.layer_config()
        self.layers = nn.ModuleList([ViTLayer(layer, causal=True)
                                     for _ in range(cfg.num_hidden_layers)])
        self.final_layer_norm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Linear(c, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids ``[B, T]`` -> (last hidden state ``[B, T, C]``, text
        features ``[B, projection_dim]``)."""
        B, T = input_ids.shape
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[:T].to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.final_layer_norm(x)
        is_eos = input_ids == self.cfg.eos_token_id
        first = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                            torch.full_like(input_ids[:, 0], T - 1))
        pooled = x[torch.arange(B, device=x.device), first]
        return x, self.text_projection(pooled)


def convert_clip_text(num_layers: int, prefix: str = "text_model.") -> NameMap:
    """HF `CLIPTextModel(WithProjection)` -> `CLIPTextModel`."""
    e = f"{prefix}embeddings."
    nmap: NameMap = {
        "token_embedding.weight": same(f"{e}token_embedding.weight"),
        "position_embedding": same(f"{e}position_embedding.weight"),
        "final_layer_norm.weight": same(f"{prefix}final_layer_norm.weight"),
        "final_layer_norm.bias": same(f"{prefix}final_layer_norm.bias"),
        "text_projection.weight": same("text_projection.weight"),
    }
    nmap.update(clip_layers(num_layers, f"{prefix}encoder.layers."))
    return nmap


class CLIPVisionTower(nn.Module):
    """HF ``CLIPModel.get_image_features``: the CLIP ViT (the port's
    `ViTEmbeddings` and `ViTLayer`), its cls token through
    ``post_layernorm`` and ``visual_projection``."""

    def __init__(self, cfg: ViTConfig, projection_dim: int):
        super().__init__()
        self.cfg = cfg
        self.embeddings = ViTEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([ViTLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)
        self.visual_projection = nn.Linear(cfg.hidden_size, projection_dim,
                                           bias=False)

    def project(self, cls: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.post_layernorm(cls))


def convert_clip_vision(num_layers: int, prefix: str = "vision_model.") -> NameMap:
    """HF `CLIPModel`'s vision side -> `CLIPVisionTower`."""
    nmap = convert_clip_vit(num_layers, prefix)
    for leaf in ("weight", "bias"):
        nmap[f"post_layernorm.{leaf}"] = same(f"{prefix}post_layernorm.{leaf}")
    nmap["visual_projection.weight"] = same("visual_projection.weight")
    return nmap


# what a `CLIPModel` checkpoint holds beside the two towers
CLIP_SKIPS = (r"^logit_scale$", r"(^|\.)position_ids$")


def clip_configs(sd, heads: Tuple[Optional[int], Optional[int]] = (None, None),
                 eos_token_id: int = 49407
                 ) -> Tuple[CLIPTextConfig, ViTConfig, int]:
    """The text and vision configs of an HF CLIP state dict, read from its
    shapes; ``heads`` (text, vision) default to heads of 64 channels, as
    every released CLIP has."""
    def layers(prefix):
        return 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd
                       if k.startswith(prefix))

    tok = sd.shape("text_model.embeddings.token_embedding.weight")
    proj = sd.shape("text_projection.weight")[0]
    text = CLIPTextConfig(
        vocab_size=tok[0], hidden_size=tok[1],
        intermediate_size=sd.shape("text_model.encoder.layers.0.mlp.fc1.weight")[0],
        num_hidden_layers=layers("text_model.encoder.layers."),
        num_attention_heads=heads[0] or tok[1] // 64,
        max_position_embeddings=sd.shape(
            "text_model.embeddings.position_embedding.weight")[0],
        projection_dim=proj, eos_token_id=eos_token_id)
    patch = sd.shape("vision_model.embeddings.patch_embedding.weight")
    n_pos = sd.shape("vision_model.embeddings.position_embedding.weight")[0]
    grid = int(round((n_pos - 1) ** 0.5))
    vision = ViTConfig(
        hidden_size=patch[0],
        intermediate_size=sd.shape(
            "vision_model.encoder.layers.0.mlp.fc1.weight")[0],
        num_hidden_layers=layers("vision_model.encoder.layers."),
        num_attention_heads=heads[1] or patch[0] // 64, patch_size=patch[2],
        image_size=grid * patch[2])
    return text, vision, proj


def load_clip(sd, device, dtype=torch.float32,
              heads: Tuple[Optional[int], Optional[int]] = (None, None),
              eos_token_id: int = 49407
              ) -> Tuple[CLIPTextModel, CLIPVisionTower]:
    """Both towers of an HF CLIP state dict (`utils.state_dict_io`), on
    ``device`` in ``dtype``, in eval mode; every key of ``sd`` is read but
    ``logit_scale`` and the position-id buffers."""
    text_cfg, vision_cfg, proj = clip_configs(sd, heads, eos_token_id)
    with torch.device("meta"):
        pair = nn.ModuleDict({"text": CLIPTextModel(text_cfg),
                              "vision": CLIPVisionTower(vision_cfg, proj)})
    pair = pair.to(dtype=dtype).to_empty(device=device)
    nmap = prefixed("text.", convert_clip_text(text_cfg.num_hidden_layers))
    nmap.update(prefixed("vision.", convert_clip_vision(
        vision_cfg.num_hidden_layers)))
    params = dict(pair.named_parameters())
    check_coverage(nmap, sd.keys(), params, CLIP_SKIPS)
    stream_into(params, nmap, sd)
    return pair["text"].eval(), pair["vision"].eval()
