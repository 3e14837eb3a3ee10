"""AutoencoderKL, the SD latent VAE, NHWC (counterpart of
`mm_interleaved_tpu/models/sd/vae.py`).

``decode(z, dtype)`` divides by the scaling factor and runs
``post_quant_conv`` in fp32, then the decoder in ``dtype``
(`ImageDecoderConfig.vae_decode_dtype` on the generation path).  The mid
`AttnBlock` keeps its own fp32 softmax, as in the JAX package, where it is
not a flash call either.  ``encode`` takes its noise as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.group_norm import GroupNorm, GroupNormSiLU
from .nhwc import Conv2d, linear, upsample2x


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


_EPS = 1e-6


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = GroupNormSiLU(in_ch, min(groups, in_ch), _EPS)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNormSiLU(out_ch, min(groups, out_ch), _EPS)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x.to(h.dtype) + h


class AttnBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, min(groups, ch), _EPS)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.Linear(ch, ch)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q, k, v = (linear(m, h) for m in (self.to_q, self.to_k, self.to_v))
        attn = torch.softmax(
            torch.einsum("bqc,bkc->bqk", q.float(), k.float()) * C ** -0.5,
            dim=-1)
        h = torch.einsum("bqk,bkc->bqc", attn.to(v.dtype), v)
        h = linear(self.to_out, h).reshape(B, H, W, C)
        return x.to(h.dtype) + h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        chans = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        ch = chans[0]
        for i, out in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(ch, out, g))
                ch = out
            if i != len(chans) - 1:
                # flax pads ((0, 1), (0, 1)); the pad is explicit in forward
                self.add_module(f"down_{i}_downsample",
                                Conv2d(out, out, 3, stride=2))
        self.mid_res_0 = ResnetBlock(ch, ch, g)
        self.mid_attn = AttnBlock(ch, g)
        self.mid_res_1 = ResnetBlock(ch, ch, g)
        self.conv_norm_out = GroupNormSiLU(ch, g, _EPS)
        self.conv_out = Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x, dtype=torch.float32):
        c = self.cfg
        h = self.conv_in(x.to(dtype))
        for i in range(len(c.block_out_channels)):
            for j in range(c.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h)
            if i != len(c.block_out_channels) - 1:
                h = getattr(self, f"down_{i}_downsample")(
                    F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        return self.conv_out(self.conv_norm_out(h).float())


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_num_groups
        ch = cfg.block_out_channels[-1]
        self.conv_in = Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_res_0 = ResnetBlock(ch, ch, g)
        self.mid_attn = AttnBlock(ch, g)
        self.mid_res_1 = ResnetBlock(ch, ch, g)
        rev = tuple(reversed(cfg.block_out_channels))
        for i, out in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(ch, out, g))
                ch = out
            if i != len(rev) - 1:
                self.add_module(f"up_{i}_upsample",
                                Conv2d(out, out, 3, padding=1))
        self.conv_norm_out = GroupNormSiLU(ch, g, _EPS)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z, dtype=torch.float32):
        c = self.cfg
        h = self.conv_in(z.to(dtype))
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h)))
        n = len(c.block_out_channels)
        for i in range(n):
            for j in range(c.layers_per_block + 1):
                h = getattr(self, f"up_{i}_res_{j}")(h)
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(upsample2x(h))
        h = self.conv_norm_out(h)
        # flax's conv_out has no dtype: it computes in the params' fp32
        return self.conv_out(h.float())


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                 2 * cfg.latent_channels, 1)
        self.post_quant_conv = Conv2d(cfg.latent_channels,
                                      cfg.latent_channels, 1)

    def encode(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None,
               sample: bool = True, dtype=torch.float32) -> torch.Tensor:
        """x in [-1, 1], NHWC -> latents scaled by the scaling factor;
        ``noise`` (the shape of the latents) draws the sample."""
        x = x.float()
        moments = self.quant_conv(self.encoder(x, dtype).float())
        mean, logvar = moments.chunk(2, dim=-1)
        if sample:
            if noise is None:
                raise ValueError("encode(sample=True) needs noise")
            z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise
        else:
            z = mean
        return z * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        z = z.float() / self.cfg.scaling_factor
        return self.decoder(self.post_quant_conv(z), dtype).float()
