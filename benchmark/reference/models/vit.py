"""CLIP vision transformer (counterpart of `mm_interleaved_tpu/models/vit.py`).

Public tensors are NHWC / ``[B, T, C]`` as in the JAX package; the patch
convolution permutes to NCHW internally.  Cut over ``tensor``
(`parallel.tensor`), a `ViTLayer` holds this rank's heads and hidden
columns and sums each row-parallel output over its pair's group.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.attention import dot_product_attention
from ..ops.pos_embed import resize_abs_pos_embed
from ..parallel.tensor import row_parallel, tensor_enter


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    dtype: str = "float32"

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        # flax's nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


class ViTEmbeddings(nn.Module):
    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        c = config.hidden_size
        self.patch_embedding = nn.Conv2d(
            3, c, config.patch_size, stride=config.patch_size, bias=False
        )
        self.class_embedding = nn.Parameter(torch.empty(c))
        self.position_embedding = nn.Parameter(
            torch.empty(config.grid_size ** 2 + 1, c)
        )

    def init_weights(self, g: torch.Generator) -> None:
        self.class_embedding.data.normal_(0.0, 0.02, generator=g)
        self.position_embedding.data.normal_(0.0, 0.02, generator=g)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: [B, H, W, 3] -> [B, 1 + H/p * W/p, C]."""
        cfg = self.config
        B = pixel_values.shape[0]
        x = self.patch_embedding(
            pixel_values.permute(0, 3, 1, 2).to(self.patch_embedding.weight.dtype)
        )
        gh = x.shape[2]
        patches = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(B, 1, -1)
        pos = self.position_embedding
        grid_pos = resize_abs_pos_embed(pos[1:], cfg.grid_size, gh)
        pos = torch.cat([pos[:1], grid_pos], dim=0)
        x = torch.cat([cls, patches], dim=1)
        return x + pos[None].to(x.dtype)


class ViTLayer(nn.Module):
    """A pre-LN transformer block; ``causal`` for the CLIP text tower."""

    def __init__(self, config: ViTConfig, causal: bool = False):
        super().__init__()
        self.config = config
        self.causal = causal
        c = config.hidden_size
        eps = config.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(c, eps=eps)
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)
        self.layer_norm2 = nn.LayerNorm(c, eps=eps)
        self.fc1 = nn.Linear(c, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, c)
        self.act = _act(config.hidden_act)
        self.attn_group = None
        self.ffn_group = None

    def tensor_pairs(self):
        c = self.config
        return (("attn_group", c.num_attention_heads,
                 ("q_proj", "k_proj", "v_proj", "out_proj")),
                ("ffn_group", c.intermediate_size, ("fc1", "fc2")))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        hd = C // self.config.num_attention_heads
        nh = self.q_proj.out_features // hd  # all heads, or this rank's
        h = tensor_enter(self.layer_norm1(x), self.attn_group)
        q = self.q_proj(h).view(B, T, nh, hd)
        k = self.k_proj(h).view(B, T, nh, hd)
        v = self.v_proj(h).view(B, T, nh, hd)
        attn = dot_product_attention(q, k, v, causal=self.causal)
        attn = attn.reshape(B, T, nh * hd)
        x = x + row_parallel(self.out_proj, attn, self.attn_group)
        h = tensor_enter(self.layer_norm2(x), self.ffn_group)
        h = row_parallel(self.fc2, self.act(self.fc1(h)), self.ffn_group)
        return x + h
