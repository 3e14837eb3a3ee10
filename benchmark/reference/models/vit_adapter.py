"""ViT-Adapter on top of the CLIP ViT, producing the multi-scale pyramid
(counterpart of `mm_interleaved_tpu/models/vit_adapter.py`).

Feature maps are NHWC at every interface, as in the JAX package; the
convolutions permute to NCHW and back.  Resizes follow `jax.image.resize`
(antialiased when they shrink), through `ops.pos_embed.resize_nhwc`.
Cut over ``tensor`` (`parallel.tensor`), the deformable attentions hold
this rank's heads and the `ConvFFN` its hidden channels (``fc1``'s rows,
``dwconv``'s channels: a depthwise conv is per channel); the SPM stays
whole.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.pos_embed import resize_nhwc
from ..parallel.tensor import row_parallel, tensor_enter
from .deform_attn import MSDeformAttn, grid_reference_points
from .vit import ViTConfig, ViTEmbeddings, ViTLayer


@dataclasses.dataclass(frozen=True)
class ViTAdapterConfig:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    conv_inplane: int = 64
    n_points: int = 4
    deform_ratio: float = 0.5
    cffn_ratio: float = 0.25
    num_interactions: int = 4
    extra_extractors: int = 2
    layer_norm_eps: float = 1e-6

    @property
    def dim(self) -> int:
        return self.vit.hidden_size

    @property
    def grid(self) -> int:
        return self.vit.grid_size

    @property
    def spm_size(self) -> int:
        return self.grid * 16

    @property
    def injector_levels(self) -> Tuple[Tuple[int, int], ...]:
        g = self.grid
        return ((2 * g, 2 * g), (g, g), (g // 2, g // 2))

    @property
    def extractor_levels(self) -> Tuple[Tuple[int, int], ...]:
        g = self.grid
        return ((g, g),)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvLNRelu(nn.Module):
    def __init__(self, in_ch: int, features: int, stride: int, eps: float):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1,
                              bias=False)
        self.norm = nn.LayerNorm(features, eps=eps)

    def forward(self, x):
        return F.relu(self.norm(conv_nhwc(self.conv, x)))


class SpatialPriorModule(nn.Module):
    """Conv pyramid at strides 4/8/16/32."""

    def __init__(self, inplanes: int = 64, embed_dim: int = 1024,
                 eps: float = 1e-6):
        super().__init__()
        p = inplanes
        self.convs = nn.ModuleList([
            ConvLNRelu(3, p, 2, eps),
            ConvLNRelu(p, p, 1, eps),
            ConvLNRelu(p, p, 1, eps),
            ConvLNRelu(p, 2 * p, 2, eps),
            ConvLNRelu(2 * p, 4 * p, 2, eps),
            ConvLNRelu(4 * p, 4 * p, 2, eps),
        ])
        self.fc1 = nn.Conv2d(p, embed_dim, 1)
        self.fc2 = nn.Conv2d(2 * p, embed_dim, 1)
        self.fc3 = nn.Conv2d(4 * p, embed_dim, 1)
        self.fc4 = nn.Conv2d(4 * p, embed_dim, 1)

    def forward(self, x):
        for m in self.convs[:3]:  # stem
            x = m(x)
        # flax's max_pool pads with -inf, as torch's does
        c1 = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1)
        c1 = c1.permute(0, 2, 3, 1)
        c2 = self.convs[3](c1)
        c3 = self.convs[4](c2)
        c4 = self.convs[5](c3)
        return (conv_nhwc(self.fc1, c1), conv_nhwc(self.fc2, c2),
                conv_nhwc(self.fc3, c3), conv_nhwc(self.fc4, c4))


class ConvFFN(nn.Module):
    """FFN with one depthwise 3x3 conv applied per pyramid level."""

    def __init__(self, dim: int, hidden: int,
                 level_shapes: Sequence[Tuple[int, int]]):
        super().__init__()
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tensor_group = None

    def tensor_pairs(self):
        return (("tensor_group", self.fc1.out_features,
                 ("fc1", "dwconv", "fc2")),)

    def forward(self, x):  # [B, sum(HW), dim]
        B = x.shape[0]
        x = self.fc1(tensor_enter(x, self.tensor_group))
        C = x.shape[-1]
        outs, start = [], 0
        for h, w in self.level_shapes:
            chunk = x[:, start:start + h * w].reshape(B, h, w, C)
            outs.append(conv_nhwc(self.dwconv, chunk).reshape(B, h * w, C))
            start += h * w
        x = F.gelu(torch.cat(outs, dim=1))  # exact erf GELU
        return row_parallel(self.fc2, x, self.tensor_group)


def _deform(c: ViTAdapterConfig, levels) -> MSDeformAttn:
    return MSDeformAttn(
        d_model=c.dim, n_heads=c.vit.num_attention_heads, n_points=c.n_points,
        ratio=c.deform_ratio, level_shapes=levels,
    )


class Injector(nn.Module):
    """Pyramid -> ViT tokens, gamma-gated."""

    def __init__(self, cfg: ViTAdapterConfig):
        super().__init__()
        self.query_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.feat_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.attn = _deform(cfg, cfg.injector_levels)
        self.gamma = nn.Parameter(torch.empty(cfg.dim))

    def init_weights(self, g: torch.Generator) -> None:
        self.gamma.data.zero_()

    def forward(self, query, reference_points, feat):
        attn = self.attn(self.query_norm(query), reference_points,
                         self.feat_norm(feat))
        return query + self.gamma.to(attn.dtype) * attn


class Extractor(nn.Module):
    """ViT tokens -> pyramid, with ConvFFN."""

    def __init__(self, cfg: ViTAdapterConfig):
        super().__init__()
        self.query_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.feat_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.attn = _deform(cfg, cfg.extractor_levels)
        self.ffn_norm = nn.LayerNorm(cfg.dim, eps=cfg.layer_norm_eps)
        self.ffn = ConvFFN(cfg.dim, int(cfg.dim * cfg.cffn_ratio),
                           cfg.injector_levels)

    def forward(self, query, reference_points, feat):
        query = query + self.attn(self.query_norm(query), reference_points,
                                  self.feat_norm(feat))
        return query + self.ffn(self.ffn_norm(query))


class CLIPViTAdapter(nn.Module):
    """CLIP ViT + adapter; returns (last_hidden_state, 4-level pyramid)."""

    def __init__(self, cfg: ViTAdapterConfig):
        super().__init__()
        self.cfg = cfg
        vit = cfg.vit
        if vit.num_hidden_layers % cfg.num_interactions:
            raise ValueError("num_hidden_layers must divide into "
                             "num_interactions groups")
        self.embeddings = ViTEmbeddings(vit)
        self.pre_layrnorm = nn.LayerNorm(vit.hidden_size,
                                         eps=vit.layer_norm_eps)
        self.adapter_spm = SpatialPriorModule(cfg.conv_inplane, cfg.dim,
                                              cfg.layer_norm_eps)
        self.adapter_level_embed = nn.Parameter(torch.empty(3, cfg.dim))
        self.layers = nn.ModuleList(
            [ViTLayer(vit) for _ in range(vit.num_hidden_layers)]
        )
        self.injectors = nn.ModuleList(
            [Injector(cfg) for _ in range(cfg.num_interactions)]
        )
        self.extractors = nn.ModuleList(
            [Extractor(cfg) for _ in range(cfg.num_interactions)]
        )
        self.extra_extractors = nn.ModuleList(
            [Extractor(cfg) for _ in range(cfg.extra_extractors)]
        )
        self.adapter_up = nn.ConvTranspose2d(cfg.dim, cfg.dim, 2, stride=2)

    def init_weights(self, g: torch.Generator) -> None:
        self.adapter_level_embed.data.zero_()

    def forward(self, pixel_values: torch.Tensor):
        c = self.cfg
        dim = c.dim
        B = pixel_values.shape[0]
        g = c.grid
        n_groups = c.num_interactions
        per_group = c.vit.num_hidden_layers // n_groups
        dtype = self.pre_layrnorm.weight.dtype
        dev = pixel_values.device

        x = self.pre_layrnorm(self.embeddings(pixel_values))
        cls, tokens = x[:, :1], x[:, 1:]

        pix = resize_nhwc(pixel_values, (c.spm_size, c.spm_size), "bilinear")
        c1, c2, c3, c4 = self.adapter_spm(pix.to(dtype))
        lvl = self.adapter_level_embed
        cfeat = torch.cat([
            c2.reshape(B, -1, dim) + lvl[0],
            c3.reshape(B, -1, dim) + lvl[1],
            c4.reshape(B, -1, dim) + lvl[2],
        ], dim=1)

        inj_ref = torch.from_numpy(grid_reference_points(((g, g),)))[None]
        ext_ref = torch.from_numpy(
            grid_reference_points(c.injector_levels))[None]
        inj_ref, ext_ref = inj_ref.to(dev), ext_ref.to(dev)

        group_maps = []
        for gi in range(n_groups):
            tokens = self.injectors[gi](tokens, inj_ref, cfeat)
            x = torch.cat([cls, tokens], dim=1)
            for li in range(gi * per_group, (gi + 1) * per_group):
                x = self.layers[li](x)
            cls, tokens = x[:, :1], x[:, 1:]
            cfeat = self.extractors[gi](cfeat, ext_ref, tokens)
            if gi == n_groups - 1:
                for ext in self.extra_extractors:
                    cfeat = ext(cfeat, ext_ref, tokens)
            group_maps.append(tokens.reshape(B, g, g, dim))

        n2 = 4 * g * g
        c2m = cfeat[:, :n2].reshape(B, 2 * g, 2 * g, dim)
        c3m = cfeat[:, n2:n2 + g * g].reshape(B, g, g, dim)
        c4m = cfeat[:, n2 + g * g:].reshape(B, g // 2, g // 2, dim)
        c1m = conv_nhwc(self.adapter_up, c2m) + c1

        def up(feat, size):
            return resize_nhwc(feat, (size, size), "bilinear")

        x1, x2, x3, x4 = group_maps
        c1m = c1m + up(x1, 4 * g)
        c2m = c2m + up(x2, 2 * g)
        c3m = c3m + x3
        c4m = c4m + up(x4, g // 2)  # shrinks: antialiased, as in JAX

        last_hidden_state = torch.cat(
            [cls, group_maps[-1].reshape(B, g * g, dim)], dim=1
        )
        return last_hidden_state, (c1m, c2m, c3m, c4m)
