"""UNet2DConditionModel, the SD 2.1-base architecture, NHWC (counterpart of
`mm_interleaved_tpu/models/sd/unet.py`), with the MMFS readout of the
previous image's pyramid added to the down residuals and the mid sample.

Modules keep the JAX names (``down_{i}_res_{j}``, ``down_{i}_attn_{j}``,
``down_{i}_downsample``, ``mid_res_0``, ``mid_attn``, ``up_{i}_res_{j}``,
``up_{i}_upsample``, ``mmfs_net``, ...), so the weight bridge is a
rename-free map.  Attention goes through `ops.attention` (the flash kernel
on the card), the ResnetBlock norms through the GroupNorm+SiLU kernel, and
the feed-forward of the blocks of width <= 640 through the fused GEGLU
kernel when autograd does not record the call.  With ``remat``, each
ResnetBlock and SpatialTransformer is recomputed in the backward of a call
that autograd records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.attention import dot_product_attention
from ...ops.geglu import geglu_fused_eligible, geglu_mlp
from ...ops.group_norm import GroupNorm, GroupNormSiLU
from ..remat import remat_call
from .mmfs_net import MMFSNet, MMFSNetConfig
from .nhwc import Conv2d, upsample2x


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: int = 64  # per-head width (SD2.x uses ch/64 heads)
    norm_num_groups: int = 32
    mmfs: Optional[MMFSNetConfig] = None
    dtype: str = "float32"
    remat: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def down_residual_spec(self):
        """(channels, sizes) of the down-block residual stack: one entry per
        skip connection, in emission order."""
        chans, sizes = [self.block_out_channels[0]], [self.sample_size]
        size = self.sample_size
        for i, ch in enumerate(self.block_out_channels):
            for _ in range(self.layers_per_block):
                chans.append(ch)
                sizes.append(size)
            if i != len(self.block_out_channels) - 1:
                size //= 2
                chans.append(ch)
                sizes.append(size)
        return tuple(chans), tuple(sizes)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoidal embedding (``flip_sin_to_cos``, no shift):
    ``[B] -> [B, dim]`` fp32, ``[cos, sin]``."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_ch, min(groups, in_ch), 1e-5)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNormSiLU(out_ch, min(groups, out_ch), 1e-5)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb):
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, cross_dim: int):
        super().__init__()
        self.n_heads = n_heads
        for p, kv in (("attn1", dim), ("attn2", cross_dim)):
            setattr(self, f"{p}_q", nn.Linear(dim, dim, bias=False))
            setattr(self, f"{p}_k", nn.Linear(kv, dim, bias=False))
            setattr(self, f"{p}_v", nn.Linear(kv, dim, bias=False))
            setattr(self, f"{p}_out", nn.Linear(dim, dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff_in = nn.Linear(dim, 8 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def _attend(self, h, kv, p):
        B, T, d = h.shape
        S = kv.shape[1]
        nh = self.n_heads
        q = getattr(self, f"{p}_q")(h).reshape(B, T, nh, d // nh)
        k = getattr(self, f"{p}_k")(kv).reshape(B, S, nh, d // nh)
        v = getattr(self, f"{p}_v")(kv).reshape(B, S, nh, d // nh)
        o = dot_product_attention(q, k, v).reshape(B, T, d)
        return getattr(self, f"{p}_out")(o)

    def forward(self, x, context):
        h = self.norm1(x)
        x = x + self._attend(h, h, "attn1")
        h = self.norm2(x)
        x = x + self._attend(h, context, "attn2")
        h = self.norm3(x)
        if geglu_fused_eligible(x.shape[-1], h, self.ff_in.weight,
                                self.ff_in.bias, self.ff_out.weight,
                                self.ff_out.bias):
            return x + geglu_mlp(h, self.ff_in.weight, self.ff_in.bias,
                                 self.ff_out.weight, self.ff_out.bias)
        a, g = self.ff_in(h).chunk(2, dim=-1)
        return x + self.ff_out(a * F.gelu(g))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, n_heads: int, cross_dim: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(ch, groups, 1e-6)
        self.proj_in = nn.Linear(ch, ch)
        self.block = TransformerBlock(ch, n_heads, cross_dim)
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context):
        B, H, W, C = x.shape
        h = self.proj_in(self.norm(x).reshape(B, H * W, C))
        h = self.proj_out(self.block(h, context))
        return x + h.reshape(B, H, W, C)


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        chans = c.block_out_channels
        n = len(chans)
        g = c.norm_num_groups
        temb = c.time_embed_dim
        self.time_fc1 = nn.Linear(chans[0], temb)
        self.time_fc2 = nn.Linear(temb, temb)
        self.conv_in = Conv2d(c.in_channels, chans[0], 3, padding=1)

        def attn(ch):
            return SpatialTransformer(ch, ch // c.attention_head_dim,
                                      c.cross_attention_dim, g)

        ch = chans[0]
        skips = [ch]
        for i, out in enumerate(chans):
            for j in range(c.layers_per_block):
                self.add_module(f"down_{i}_res_{j}",
                                ResnetBlock(ch, out, temb, g))
                ch = out
                if i != n - 1:
                    self.add_module(f"down_{i}_attn_{j}", attn(ch))
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample",
                                Conv2d(ch, ch, 3, stride=2, padding=1))
                skips.append(ch)
        self.mid_res_0 = ResnetBlock(ch, ch, temb, g)
        self.mid_attn = attn(ch)
        self.mid_res_1 = ResnetBlock(ch, ch, temb, g)
        if c.mmfs is not None:
            res_chans, sizes = c.down_residual_spec()
            self.mmfs_net = MMFSNet(c.mmfs, res_chans, sizes, ch, sizes[-1])
        for i, out in enumerate(reversed(chans)):
            for j in range(c.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock(ch + skips.pop(), out, temb, g))
                ch = out
                if i != 0:
                    self.add_module(f"up_{i}_attn_{j}", attn(ch))
            if i != n - 1:
                self.add_module(f"up_{i}_upsample",
                                Conv2d(ch, ch, 3, padding=1))
        self.conv_norm_out = GroupNormSiLU(ch, g, 1e-5)
        self.conv_out = Conv2d(ch, c.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,  # [B, H, W, in_channels] latents
        timesteps: torch.Tensor,  # [B]
        encoder_hidden_states: torch.Tensor,  # [B, S, cross_dim]
        mmfs_values: Optional[torch.Tensor] = None,  # [Bv, n_img, hw, Cv]
        mmfs_mask: Optional[torch.Tensor] = None,  # [Bv, n_img]
        mmfs_prepared: Optional[tuple] = None,  # `MMFSNet.prepare`
    ) -> torch.Tensor:
        c = self.cfg
        n = len(c.block_out_channels)
        dtype = self.conv_in.weight.dtype
        temb = timestep_embedding(timesteps, c.block_out_channels[0])
        temb = self.time_fc2(F.silu(self.time_fc1(temb.to(dtype))))
        ctx = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.to(dtype))

        def block(name, *args):
            return remat_call(c.remat, getattr(self, name), *args)

        res_stack = [h]
        for i in range(n):
            for j in range(c.layers_per_block):
                h = block(f"down_{i}_res_{j}", h, temb)
                if i != n - 1:
                    h = block(f"down_{i}_attn_{j}", h, ctx)
                res_stack.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                res_stack.append(h)

        h = block("mid_res_0", h, temb)
        h = block("mid_attn", h, ctx)
        h = block("mid_res_1", h, temb)

        if c.mmfs is not None and mmfs_prepared is None \
                and mmfs_values is not None:
            mmfs_prepared = self.mmfs_net.prepare(mmfs_values, mmfs_mask)
        if c.mmfs is not None and mmfs_prepared is not None:
            h, res = self.mmfs_net(h, tuple(res_stack), mmfs_prepared)
            res_stack = list(res)

        for i in range(n):
            for j in range(c.layers_per_block + 1):
                h = torch.cat([h, res_stack.pop()], dim=-1)
                h = block(f"up_{i}_res_{j}", h, temb)
                if i != 0:
                    h = block(f"up_{i}_attn_{j}", h, ctx)
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(upsample2x(h))

        h = self.conv_norm_out(h)
        # flax's conv_out has no dtype: it computes in the params' fp32
        return self.conv_out(h.float())
