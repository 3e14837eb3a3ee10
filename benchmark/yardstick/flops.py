"""The model FLOPs one unit of a mix needs: the plain reference
(`benchmark.reference`) run on the ``meta`` device at the unit's shapes
under `torch.utils.flop_counter.FlopCounterMode`, which counts the
matrix products, convolutions and attention products from their shapes
(elementwise work is not counted).  Only the configuration and the
shapes enter: nothing of the program.  The denoise loop is counted at
one step, and the UNet's count scaled to the mix's steps; beam search is
counted as it runs, with its cache."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def _meta_model(ref_cfg):
    from ..reference.models.mm_interleaved import MMInterleaved

    with torch.device("meta"):
        model = MMInterleaved(ref_cfg)
    return model.eval().requires_grad_(False)


def _on_meta(unit: dict) -> dict:
    return {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in unit.items()}


@torch.no_grad()
def unit_flops(ref_cfg, traffic, unit: dict) -> float:
    """The FLOPs of one unit of ``traffic`` with inputs ``unit`` (its
    shapes and counts read on the host)."""
    model = _meta_model(ref_cfg)
    spec = traffic.spec
    host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in unit.items()}
    u = _on_meta(host)
    if traffic.entry == "generate_images":
        from ..reference.generation.diffusion import generate_images

        with FlopCounterMode(display=False) as fc:
            inp = model.generate_image_inputs(
                u["text_ids"], u["image_tensors"], u["num_image_per_seq"],
                u["attention_mask"])
        context = fc.get_total_flops()
        rows = host["target_rows"]
        sel = [x[rows.to("meta")] for x in inp]
        dec = model.cfg.image_decoder
        shape = (len(rows), dec.latent_size, dec.latent_size,
                 dec.vae.latent_channels)
        lat = torch.zeros(shape, device="meta")
        noi = torch.zeros((1,) + shape, device="meta")
        with FlopCounterMode(display=False) as fc:
            generate_images(model, *sel, num_inference_steps=1,
                            guidance_scale=spec["guidance_scale"],
                            sampler=spec["sampler"], latents=lat,
                            noises=noi)
        one_step = fc.get_total_flops()
        dec_m = model.image_decoder
        ctx, neg = dec_m.resample_context(sel[0], sel[1])
        do_cfg = spec["guidance_scale"] > 1.0
        ctx_in = torch.cat([neg, ctx]) if do_cfg else ctx
        prepared = (dec_m.unet.mmfs_net.prepare(sel[2], sel[3])
                    if dec.unet.mmfs is not None else None)
        x = torch.zeros((ctx_in.shape[0],) + shape[1:], device="meta")
        t = torch.zeros((ctx_in.shape[0],), dtype=torch.int32,
                        device="meta")
        with FlopCounterMode(display=False) as fc:
            dec_m.unet_pred(x, t, ctx_in, mmfs_prepared=prepared)
        step = fc.get_total_flops()
        return float(context + one_step
                     + (spec["num_inference_steps"] - 1) * step)
    if traffic.entry == "generate_texts":
        from ..reference.generation.text import (TextGenerationConfig,
                                                 generate_texts)

        cfg = TextGenerationConfig(
            max_new_tokens=spec["max_new_tokens"],
            min_new_tokens=spec["min_new_tokens"],
            num_beams=spec["num_beams"],
            length_penalty=spec["length_penalty"])
        with FlopCounterMode(display=False) as fc:
            generate_texts(model, u["text_ids"], u["image_tensors"],
                           u["num_image_per_seq"], u["attention_mask"], cfg)
        return float(fc.get_total_flops())
    raise ValueError(traffic.entry)
