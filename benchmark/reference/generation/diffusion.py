"""The diffusion sampling loop with classifier-free guidance (counterpart of
`mm_interleaved_tpu/generation/diffusion.py`).

A Python loop over the denoise steps.  The CFG batch is ``[neg, ctx]``,
unconditional first, and ``pred = uncond + g * (cond - uncond)``.  The MMFS
image side (value projections, masks and delta tables of every block) is
computed once, before the loop, at the pre-CFG batch; the UNet's
factorised kernel reads it for both halves.  The VAE decode runs at the
end.  ``latents`` and ``noises`` (``[steps, B, h, w, 4]``) may be injected
instead of drawn from ``generator``; `draw_noise` draws them, all before
the loop, so that a shard of the batch can take its rows of the draws made
at the global batch (`parallel.inference.ShardedGenerator`).
"""

from __future__ import annotations

from typing import Optional

import torch


def draw_noise(model, batch: int, num_inference_steps: int, sampler: str,
               generator: Optional[torch.Generator] = None, device=None,
               latents: Optional[torch.Tensor] = None,
               noises: Optional[torch.Tensor] = None):
    """``(latents [B, h, w, 4], noises [steps, B, h, w, 4] or None)`` for
    ``batch`` rows: the given ones, the rest drawn from ``generator`` in
    the loop's order (the latents, then one draw a DDPM step; DDIM draws
    no noise)."""
    cfg = model.cfg.image_decoder
    shape = (batch, cfg.latent_size, cfg.latent_size,
             cfg.vae.latent_channels)
    if latents is None:
        latents = torch.randn(shape, generator=generator, device=device,
                              dtype=torch.float32)
    if sampler == "ddpm" and noises is None:
        noises = torch.stack([
            torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
            for _ in range(num_inference_steps)])
    return latents, noises


@torch.no_grad()
def generate_images(
    model,
    context_features: torch.Tensor,  # [B, L_ctx, C_llm]
    context_attention_mask: torch.Tensor,  # [B, L_ctx]
    mmfs_values: Optional[torch.Tensor] = None,  # [B, n_img, sum hw, Cv]
    mmfs_mask: Optional[torch.Tensor] = None,  # [B, n_img]
    num_inference_steps: int = 30,
    guidance_scale: float = 7.5,
    sampler: str = "ddpm",
    generator: Optional[torch.Generator] = None,
    latents: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample images conditioned on LLM context windows; returns ``[B, H,
    W, 3]`` fp32 in [0, 1]."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(sampler)
    dec = model.image_decoder
    cfg = model.cfg.image_decoder
    sched = cfg.schedule
    ctx, neg = dec.resample_context(context_features, context_attention_mask)
    B = ctx.shape[0]
    dev = ctx.device
    do_cfg = guidance_scale > 1.0
    ctx_in = torch.cat([neg, ctx]) if do_cfg else ctx

    latents, noises = draw_noise(model, B, num_inference_steps, sampler,
                                 generator, dev, latents, noises)
    latents = latents.to(dev, torch.float32)

    prepared = None
    if mmfs_values is not None and cfg.unet.mmfs is not None:
        prepared = dec.unet.mmfs_net.prepare(mmfs_values, mmfs_mask)

    ts = sched.inference_timesteps(num_inference_steps)
    ts_prev = ts[1:] + [-1]
    for i, (t, t_prev) in enumerate(zip(ts, ts_prev)):
        model_in = torch.cat([latents] * 2) if do_cfg else latents
        tb = torch.full((model_in.shape[0],), t, dtype=torch.int32,
                        device=dev)
        pred = dec.unet_pred(model_in, tb, ctx_in,
                             mmfs_prepared=prepared).float()
        if do_cfg:
            uncond, cond = pred.chunk(2)
            pred = uncond + guidance_scale * (cond - uncond)
        if sampler == "ddpm":
            latents = sched.ddpm_step(pred, t, t_prev, latents,
                                      noises[i].to(dev, torch.float32))
        else:
            latents = sched.ddim_step(pred, t, t_prev, latents)
    return dec.vae_decode(latents)
