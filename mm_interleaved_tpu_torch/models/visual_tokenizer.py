"""Visual tokenizer: CLIP ViT-Adapter + perceiver resampler (counterpart of
`mm_interleaved_tpu/models/visual_tokenizer.py`).

CLIP-normalise pixels, run the adapter for the last hidden state and the
4-level pyramid, add resized 2D sin-cos position tables to every level and
to the resampler input, resample to ``num_queries`` tokens and project to
the LLM width.  Returns ``vis_embed [B, num_queries, llm_hidden]``,
``image_embeds [B, HW, C]`` and ``multiscale_features`` (NHWC maps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops.pos_embed import get_2d_sincos_pos_embed, resized_sincos_table
from .perceiver import PerceiverConfig, PerceiverResampler
from .vit_adapter import CLIPViTAdapter, ViTAdapterConfig

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class VisualTokenizerConfig:
    encoder: ViTAdapterConfig = dataclasses.field(
        default_factory=ViTAdapterConfig
    )
    perceiver: PerceiverConfig = dataclasses.field(
        default_factory=PerceiverConfig
    )
    llm_hidden_size: int = 5120
    clip_normalize: bool = True
    grid_size: int = 16


class VisualTokenizer(nn.Module):
    def __init__(self, cfg: VisualTokenizerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder.dim
        self.encoder = CLIPViTAdapter(cfg.encoder)
        self.pos_proj = nn.Linear(d, d)
        self.pos_ln = nn.LayerNorm(d, eps=1e-6)
        self.post_ln = nn.LayerNorm(d, eps=1e-6)
        self.perceiver_resampler = PerceiverResampler(cfg.perceiver)
        self.proj = nn.Linear(cfg.perceiver.hidden_size, cfg.llm_hidden_size)

    def init_weights(self, g: torch.Generator) -> None:
        self.proj.weight.data.normal_(0.0, 1e-3, generator=g)
        self.proj.bias.data.zero_()

    def forward(self, image: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """image: [B, H, W, 3] in [0, 1]; ``generator`` draws the
        resampler's dropout in training mode."""
        c = self.cfg
        d = c.encoder.dim
        dev = image.device
        if c.clip_normalize:
            mean = torch.tensor(CLIP_MEAN, dtype=image.dtype, device=dev)
            std = torch.tensor(CLIP_STD, dtype=image.dtype, device=dev)
            image = (image - mean) / std

        last_hidden, pyramid = self.encoder(image)

        pyramid_out = []
        for feat in pyramid:
            h = feat.shape[1]
            pe = torch.from_numpy(resized_sincos_table(d, c.grid_size, h))
            pyramid_out.append(
                feat + pe.to(dev, feat.dtype).reshape(1, h, h, d)
            )

        side = int(round((last_hidden.shape[1] - 1) ** 0.5))
        table = torch.from_numpy(get_2d_sincos_pos_embed(d, c.grid_size,
                                                         cls_token=True))
        grid_pe = torch.from_numpy(resized_sincos_table(d, c.grid_size, side))
        pe = torch.cat([table[:1], grid_pe], dim=0)[None].to(dev)

        q_in = self.pos_ln(self.pos_proj(last_hidden)) + pe.to(last_hidden.dtype)
        image_embeds = last_hidden + pe.to(last_hidden.dtype)
        q_in = self.post_ln(q_in)
        vis = self.perceiver_resampler(encoder_hidden_states=q_in,
                                       generator=generator)
        return dict(
            vis_embed=self.proj(vis),
            image_embeds=image_embeds[:, 1:],
            multiscale_features=tuple(pyramid_out),
        )
