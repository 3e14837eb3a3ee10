"""Image decoder: the perceiver-resampled LLM context conditioning the SD
UNet, with MMFS injection of the previous image's pyramid (counterpart of
`mm_interleaved_tpu/models/image_decoder.py`).

`forward` is the diffusion training loss; the denoise loop is
`generation.diffusion`.  The loss's random draws (the VAE's sampling
noise, the diffusion noise, the timesteps and the uncond drops) come from a
`torch.Generator` or are injected, so that a test can feed the JAX
package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .perceiver import PerceiverConfig, PerceiverResampler
from .sd.scheduler import DiffusionSchedule
from .sd.unet import UNet2DConditionModel, UNetConfig
from .sd.vae import AutoencoderKL, VAEConfig
from ..utils import draws


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

    def vae_encode(self, image: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
        """fp32 VAE encode of ``image [B, H, W, 3]`` in [-1, 1] with its
        sampling ``noise`` (the latents' shape), in chunks of
        ``vae_encode_mini_bs`` when the batch divides evenly."""
        B = image.shape[0]
        mini = self.cfg.vae_encode_mini_bs
        if mini <= 0 or B <= mini or B % mini:
            return self.vae.encode(image, noise)
        return torch.cat([self.vae.encode(x, n) for x, n in
                          zip(image.split(mini), noise.split(mini))])

    def forward(self, image_tensors, context_features, context_attention_mask,
                image_loss_mask=None, mmfs_features=None, mmfs_mask=None, *,
                generator: draws.Gen = None, vae_noise=None, noise=None,
                timesteps=None, uncond_drop=None,
                count_reduce: Optional[Callable] = None):
        """Diffusion training loss (a scalar): ``image_tensors [B, H, W, 3]``
        in [0, 1] are the targets; the context is resampled (with the
        resampler's dropout from ``generator`` in training mode) and
        replaced by ``neg_prompt_embeds`` where ``uncond_drop [B]``, drawn
        with probability ``uncond_prob``; the fp32 VAE latents, without
        gradient, are noised at ``timesteps [B]`` and the UNet's prediction
        is held against the training target, per image, masked by
        ``image_loss_mask [B]`` and averaged over the batch.  In a sharded
        step ``generator`` is a `utils.draws.RowDraws` (every draw made at
        the global batch, this rank's slots kept) and ``count_reduce`` sums
        the slot count over the ranks that hold rows, so that the loss is
        this rank's share of the global mean."""
        c = self.cfg
        B = image_tensors.shape[0]
        dev = image_tensors.device

        ctx = self.perceiver_resampler(context_features,
                                       context_attention_mask, generator)
        if c.uncond_prob > 0:
            if uncond_drop is None:
                uncond_drop = draws.rand((B,), generator,
                                         dev) < c.uncond_prob
            ctx = torch.where(uncond_drop.to(dev)[:, None, None],
                              self.neg_prompt_embeds.to(ctx.dtype), ctx)

        image = image_tensors.float() * 2.0 - 1.0
        n = c.latent_size
        shape = (B, n, n, c.vae.latent_channels)
        if vae_noise is None:
            vae_noise = draws.randn(shape, generator, dev)
        with torch.no_grad():
            latents = self.vae_encode(image, vae_noise.float())
        if noise is None:
            noise = draws.randn(shape, generator, dev)
        if timesteps is None:
            timesteps = draws.randint(0, c.schedule.num_train_timesteps, (B,),
                                      generator, dev)
        noise = noise.float()
        noisy = c.schedule.add_noise(latents, noise, timesteps)
        target = c.schedule.training_target(latents, noise, timesteps)

        pred = self.unet(noisy, timesteps, ctx, mmfs_values=mmfs_features,
                         mmfs_mask=mmfs_mask)
        loss = (pred.float() - target).square().mean(dim=(1, 2, 3))
        if image_loss_mask is not None:
            loss = loss * image_loss_mask.float()
        if count_reduce is None:
            return loss.mean()
        slots = torch.tensor(B, dtype=torch.int64, device=dev)
        return loss.sum() / count_reduce(slots)

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
