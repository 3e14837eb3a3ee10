"""Image decoder: the perceiver-resampled LLM context conditioning the SD
UNet, with MMFS injection of the previous image's pyramid (counterpart of
`mm_interleaved_tpu/models/image_decoder.py`, the generation pieces).

The training ``__call__`` (VAE encode, noising, the diffusion loss) belongs
to the training slice; the denoise loop is `generation.diffusion`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .perceiver import PerceiverConfig, PerceiverResampler
from .sd.scheduler import DiffusionSchedule
from .sd.unet import UNet2DConditionModel, UNetConfig
from .sd.vae import AutoencoderKL, VAEConfig


@dataclasses.dataclass(frozen=True)
class ImageDecoderConfig:
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    schedule: DiffusionSchedule = dataclasses.field(
        default_factory=DiffusionSchedule
    )
    perceiver: PerceiverConfig = dataclasses.field(
        default_factory=lambda: PerceiverConfig(
            num_queries=77,
            hidden_size=1024,
            encoder_hidden_size=5120,
            num_hidden_layers=1,
            num_attention_heads=16,
            cross_attention_frequency=1,
        )
    )
    uncond_prob: float = 0.1
    image_size: int = 512
    # which ViT pyramid level resolutions feed the UNet MMFS
    spatial_shapes: tuple = (64, 32, 16, 8)
    vae_encode_mini_bs: int = 32
    vae_decode_mini_bs: int = 8
    vae_decode_dtype: str = "bfloat16"

    @property
    def latent_size(self) -> int:
        return self.image_size // 2 ** (len(self.vae.block_out_channels) - 1)


class ImageDecoder(nn.Module):
    def __init__(self, cfg: ImageDecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.perceiver_resampler = PerceiverResampler(cfg.perceiver)
        self.vae = AutoencoderKL(cfg.vae)
        self.unet = UNet2DConditionModel(cfg.unet)
        self.neg_prompt_embeds = nn.Parameter(torch.empty(
            1, cfg.perceiver.num_queries, cfg.perceiver.hidden_size))

    def init_weights(self, g: torch.Generator) -> None:
        self.neg_prompt_embeds.data.normal_(0.0, 0.02, generator=g)

    def resample_context(self, context_features: torch.Tensor,
                         context_attention_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (cond ctx, neg ctx), both ``[B, num_queries, C]``."""
        ctx = self.perceiver_resampler(context_features,
                                       context_attention_mask)
        neg = self.neg_prompt_embeds.to(ctx.dtype).expand(ctx.shape)
        return ctx, neg

    def unet_pred(self, latents, timesteps, ctx, mmfs_values=None,
                  mmfs_mask=None, mmfs_prepared: Optional[tuple] = None):
        return self.unet(latents, timesteps, ctx, mmfs_values=mmfs_values,
                         mmfs_mask=mmfs_mask, mmfs_prepared=mmfs_prepared)

    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, h, w, 4]`` -> images ``[B, H, W, 3]`` in [0, 1],
        decoded in ``vae_decode_dtype``, in chunks of ``vae_decode_mini_bs``
        when the batch divides evenly."""
        dtype = getattr(torch, self.cfg.vae_decode_dtype)
        B = latents.shape[0]
        mini = self.cfg.vae_decode_mini_bs
        if mini <= 0 or B <= mini or B % mini:
            image = self.vae.decode(latents, dtype)
        else:
            image = torch.cat([self.vae.decode(z, dtype)
                               for z in latents.split(mini)])
        return (image * 0.5 + 0.5).clamp(0.0, 1.0)
