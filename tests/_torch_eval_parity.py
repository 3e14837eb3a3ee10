"""Shared fixtures of the evaluation and inference parity tests
(tests/test_torch_eval*.py): the tiny preset on both sides with noised
weights, the tokenizers, the JAX entry module, and runtimes that inject
JAX's image draws into the port's denoise.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.data.tokenizer import SimpleWordTokenizer
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu.parallel.inference import ShardedGenerator
from mm_interleaved_tpu.parallel.partition import make_mesh
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.data.tokenizer import load_tokenizer
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.parallel.inference import LocalGenerator
from mm_interleaved_tpu_torch.utils.from_flax import load_flax_params

from _torch_parity import interleaved_batch, noised

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_entry(name: str):
    """The repository's root JAX entry module ``name`` (`evaluate`,
    `inference`), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_entry_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_pair(with_image_decoder: bool):
    """(JAX config, JAX model, noised params, port model) at the tiny
    preset, the VAE decoding in fp32 on both sides."""
    cfgs = []
    for mod in (j_tiny, tcfg.tiny_config):
        c = mod(with_image_decoder=with_image_decoder)
        if with_image_decoder:
            c = dataclasses.replace(c, image_decoder=dataclasses.replace(
                c.image_decoder, vae_decode_dtype="float32"))
        cfgs.append(c)
    jcfg, pcfg = cfgs
    jmodel = MMInterleaved(jcfg)
    batch = interleaved_batch(jcfg)
    if not with_image_decoder:
        batch.pop("image_tensors_dec")
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        **{k: jnp.asarray(v) for k, v in batch.items()},
    )
    params = noised(params, seed=1)
    model = build_model(pcfg, "cpu", torch.float32)
    load_flax_params(model, params["params"])
    return jcfg, jmodel, params, model.eval()


def tokenizers(jcfg, pcfg):
    """The JAX test tokenizer and the port's (the same ids at tiny)."""
    return (SimpleWordTokenizer(vocab_size=jcfg.llm.vocab_size),
            load_tokenizer(None, vocab_size=pcfg.llm.vocab_size,
                           special=pcfg.special))


def jax_draws(rng, B: int, cfg, steps: int):
    """The latents and per-step noise JAX's `generate_images` draws from
    ``rng`` for ``B`` rows (its key sequence)."""
    idc = cfg.image_decoder
    shape = (B, idc.latent_size, idc.latent_size, idc.vae.latent_channels)
    r, r_init = jax.random.split(rng)
    latents = np.asarray(jax.random.normal(r_init, shape, jnp.float32))
    noises = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                       for k in jax.random.split(r, steps)])
    return latents, noises


class RecordingJax(ShardedGenerator):
    """The JAX runtime on a one-device mesh (each entry point jitted whole,
    so that a shape compiles once), recording each denoise call's draws and
    images."""

    def __init__(self, model, variables):
        super().__init__(model, variables,
                         make_mesh(devices=jax.devices()[:1]))
        self.draws, self.images = [], []

    def denoise(self, ctx, ctx_mask, mmfs_values, mmfs_mask, rng=None,
                num_inference_steps=30, guidance_scale=3.5, sampler="ddpm"):
        self.draws.append(jax_draws(rng, ctx.shape[0], self.model.cfg,
                                    num_inference_steps))
        out = super().denoise(ctx, ctx_mask, mmfs_values, mmfs_mask, rng,
                              num_inference_steps, guidance_scale, sampler)
        self.images.append(np.asarray(out))
        return out


class InjectedPort(LocalGenerator):
    """The port's runtime, its denoise calls fed the recorded JAX draws in
    order (the generator it is given is not used), recording the images."""

    def __init__(self, model, draws):
        super().__init__(model)
        self.draws, self.images = list(draws), []

    def denoise(self, ctx, ctx_mask, mmfs_values, mmfs_mask, generator=None,
                num_inference_steps=30, guidance_scale=3.5, sampler="ddpm",
                latents=None, noises=None):
        latents, noises = (torch.tensor(x) for x in self.draws.pop(0))
        out = super().denoise(ctx, ctx_mask, mmfs_values, mmfs_mask, None,
                              num_inference_steps, guidance_scale, sampler,
                              latents=latents, noises=noises)
        self.images.append(out.numpy())
        return out
