"""The generation runtimes (counterpart of
`mm_interleaved_tpu/parallel/inference.py`).

`LocalGenerator` and `ShardedGenerator` keep every generation call of the
evaluator and the interleaved inference loop behind one seam, with the
surface of the JAX package's runtimes: `generate_texts`,
`generate_image_inputs`, `denoise`, `generate_images` and
`generate_scores`.  The model holds its weights, so no variables are
passed.  `denoise` also takes ``latents`` and ``noises`` to inject draws.
``quantize="int8"`` replaces the LLM's projections by int8 ones in place
before the first call (`ops.quant.quantize_llm_weights`, as the JAX
runtimes quantize their variables), so every generation call of the model
(text, beam, scores and the image-prefix forward) runs the quantized LLM.

`ShardedGenerator` runs one rank of a ``(data, fsdp, tensor)`` mesh
(`parallel.partition`): the model cut over ``tensor`` into head-local
shards, the vocabulary by row (`parallel.tensor`; an int8 model is
quantized whole first, then cut), the
weights the plan shards over ``fsdp`` under FSDP2.  Every rank receives the
global batch, as one host does in JAX, runs its rows (the batch split over
``(data, fsdp)``, replicated where that does not divide it) and all-gathers
the outputs along the batch, so it returns what `LocalGenerator` returns.
Random draws (nucleus sampling's uniforms, the initial latents, the DDPM
noise) are made at the global batch on every rank from the one
``generator``, then sliced to the rank's rows; rows are split before beam
search tiles its cache and before the CFG doubling, so a rank holds whole
beams and both CFG halves of its rows.  Decode runs its fixed number of
steps (no early stop), so every rank makes the same collective calls.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..generation.diffusion import draw_noise, generate_images
from ..generation.scores import generate_scores
from ..generation.text import (TextGenerationConfig, generate_texts,
                               sample_uniforms)
from ..ops.quant import quantize_llm_weights
from .partition import axis_sizes, batch_rows, make_mesh, mesh_shape, \
    shard_fsdp
from .tensor import shard_tensor_parallel

QUANTIZE_MODES = ("int8",)


def _default_mask(model, text_ids, attention_mask):
    if attention_mask is None:
        attention_mask = (text_ids != model.cfg.special.pad_token_id).int()
    return attention_mask


class LocalGenerator:
    """One-device runtime with the JAX runtimes' five methods; with
    ``quantize="int8"`` the model's LLM is quantized in place first."""

    def __init__(self, model, quantize: Optional[str] = None):
        check_quantize(quantize)
        if quantize == "int8":
            quantize_llm_weights(model)
        self.model = model

    def generate_texts(self, text_ids, image_tensors, num_image_per_seq,
                       attention_mask=None, cfg=None, generator=None):
        return generate_texts(
            self.model, text_ids, image_tensors, num_image_per_seq,
            _default_mask(self.model, text_ids, attention_mask),
            cfg or TextGenerationConfig(), generator,
        )

    def generate_image_inputs(self, text_ids, image_tensors,
                              num_image_per_seq, attention_mask=None):
        return self.model.generate_image_inputs(
            text_ids, image_tensors, num_image_per_seq,
            _default_mask(self.model, text_ids, attention_mask))

    def denoise(self, ctx, ctx_mask, mmfs_values, mmfs_mask, generator=None,
                num_inference_steps: int = 30, guidance_scale: float = 3.5,
                sampler: str = "ddpm", latents=None, noises=None):
        """The denoise loop and the VAE decode from precomputed context
        windows and pyramids (the callers select the target rows between
        `generate_image_inputs` and this)."""
        return generate_images(
            self.model, ctx, ctx_mask, mmfs_values, mmfs_mask,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, sampler=sampler,
            generator=generator, latents=latents, noises=noises,
        )

    def generate_images(self, text_ids, image_tensors, num_image_per_seq,
                        attention_mask=None, generator=None,
                        num_inference_steps: int = 30,
                        guidance_scale: float = 3.5, sampler: str = "ddpm"):
        ctx, ctx_mask, mmfs_vals, mmfs_mask = self.generate_image_inputs(
            text_ids, image_tensors, num_image_per_seq, attention_mask)
        return self.denoise(ctx, ctx_mask, mmfs_vals, mmfs_mask, generator,
                            num_inference_steps=num_inference_steps,
                            guidance_scale=guidance_scale, sampler=sampler)

    def generate_scores(self, text_ids, options_ids, options_mask,
                        image_tensors, num_image_per_seq, attention_mask):
        return generate_scores(
            self.model, text_ids, options_ids, options_mask, image_tensors,
            num_image_per_seq, attention_mask)


class ShardedGenerator(LocalGenerator):
    """One rank of the sharded runtime on ``mesh`` (`parallel.partition.
    make_mesh`); ``model`` (whole, on this rank's device) is quantized if
    asked, then cut over ``tensor`` (``cuts``: each cut parameter's dim)
    and sharded over ``fsdp`` in place."""

    def __init__(self, model, mesh, quantize: Optional[str] = None):
        super().__init__(model, quantize)
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.cuts = shard_tensor_parallel(model, mesh)
        shard_fsdp(model, mesh)

    def _gather(self, x: Optional[torch.Tensor], rows: slice, batch: int):
        """The outputs ``x`` of this rank's ``rows`` of a global batch of
        ``batch`` rows (along dim 0, a row's entries together, as the
        image inputs' ``(b n)`` rows) -> the whole batch's: gathered over
        ``fsdp``, then over ``data``."""
        import torch.distributed as dist

        if x is None or rows.stop - rows.start == batch:
            return x
        flag = x.dtype == torch.bool
        x = (x.to(torch.uint8) if flag else x).contiguous()
        for axis in ("fsdp", "data"):
            n = self.sizes[axis]
            if n > 1:
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=self.mesh.get_group(axis))
                x = torch.cat(parts)
        return x.bool() if flag else x

    def generate_texts(self, text_ids, image_tensors, num_image_per_seq,
                       attention_mask=None, cfg=None, generator=None):
        cfg = cfg or TextGenerationConfig()
        mask = _default_mask(self.model, text_ids, attention_mask)
        B = text_ids.shape[0]
        rows = batch_rows(self.mesh, B)
        uniforms = None
        if cfg.do_sample and cfg.num_beams == 1:
            uniforms = sample_uniforms(cfg, B, generator,
                                       text_ids.device)[:, rows]
        out = generate_texts(
            self.model, text_ids[rows], image_tensors[rows],
            num_image_per_seq[rows], mask[rows], cfg, uniforms=uniforms)
        return self._gather(out, rows, B)

    def generate_image_inputs(self, text_ids, image_tensors,
                              num_image_per_seq, attention_mask=None):
        mask = _default_mask(self.model, text_ids, attention_mask)
        B = text_ids.shape[0]
        rows = batch_rows(self.mesh, B)
        out = self.model.generate_image_inputs(
            text_ids[rows], image_tensors[rows], num_image_per_seq[rows],
            mask[rows])
        return tuple(self._gather(x, rows, B) for x in out)

    def denoise(self, ctx, ctx_mask, mmfs_values, mmfs_mask, generator=None,
                num_inference_steps: int = 30, guidance_scale: float = 3.5,
                sampler: str = "ddpm", latents=None, noises=None):
        B = ctx.shape[0]
        rows = batch_rows(self.mesh, B)
        latents, noises = draw_noise(self.model, B, num_inference_steps,
                                     sampler, generator, ctx.device, latents,
                                     noises)

        def mine(x):
            return None if x is None else x[rows]

        out = generate_images(
            self.model, ctx[rows], ctx_mask[rows], mine(mmfs_values),
            mine(mmfs_mask), num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, sampler=sampler,
            latents=latents[rows],
            noises=None if noises is None else noises[:, rows])
        return self._gather(out, rows, B)

    def generate_scores(self, text_ids, options_ids, options_mask,
                        image_tensors, num_image_per_seq, attention_mask):
        B = text_ids.shape[0]
        rows = batch_rows(self.mesh, B)
        out = generate_scores(
            self.model, text_ids[rows], options_ids[rows],
            options_mask[rows], image_tensors[rows], num_image_per_seq[rows],
            attention_mask[rows])
        return self._gather(out, rows, B)


def check_quantize(quantize: Optional[str]) -> None:
    """An unknown ``quantize`` mode raises `ValueError`, as in the JAX
    runtimes."""
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}")


def _world() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def runtime_mesh_shape(mesh_cfg: Optional[Dict[str, Any]],
                       default_data: int = 1):
    """The ``(data, fsdp, tensor)`` sizes a ``mesh:`` stanza asks for
    (``data`` default 1, as the JAX runtime's, or ``default_data``; -1 is
    the rest of the world).  A stanza over more than one device with no
    process group, or whose size is not the world's, raises."""
    mesh_cfg = dict(mesh_cfg or {})
    data, fsdp, tensor = (int(mesh_cfg.get("data", default_data)),
                          int(mesh_cfg.get("fsdp", 1)),
                          int(mesh_cfg.get("tensor", 1)))
    world = _world()
    if world == 1 and max(data, 1) * fsdp * tensor > 1:
        raise RuntimeError(
            f"mesh {mesh_cfg} asks for more than one device and no process "
            "group is initialised: run one process a device under torchrun")
    return mesh_shape(data, fsdp, tensor, world)


def check_runtime(mesh_cfg=None, quantize: Optional[str] = None) -> None:
    """Refuse what the runtime cannot do (before any model is built): an
    unknown ``quantize`` mode, and a ``mesh:`` stanza that does not match
    the `torch.distributed` world (`runtime_mesh_shape`)."""
    check_quantize(quantize)
    runtime_mesh_shape(mesh_cfg)


def build_generation_runtime(model, mesh_cfg=None,
                             quantize: Optional[str] = None):
    """The entry points' factory, after `check_runtime`: `ShardedGenerator`
    on the mesh of a ``mesh:`` stanza over more than one device,
    `LocalGenerator` otherwise; ``quantize`` is applied to ``model`` in
    place."""
    shape = runtime_mesh_shape(mesh_cfg)
    check_quantize(quantize)
    if shape == (1, 1, 1):
        return LocalGenerator(model, quantize=quantize)
    device = next(model.parameters()).device
    return ShardedGenerator(model, make_mesh(*shape, device.type),
                            quantize=quantize)


def init_distributed(device: str, initialize: bool = False) -> torch.device:
    """Under torchrun (``WORLD_SIZE`` above 1, or any ``WORLD_SIZE`` with
    ``initialize``): the process group (nccl on the card, gloo with
    ``--device cpu``) and this rank's device, ``cuda:LOCAL_RANK``;
    otherwise ``device`` as given.  ``initialize`` without torchrun's
    environment raises."""
    import torch.distributed as dist

    dev = torch.device(device)
    if initialize and "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "distributed.initialize: no process group to join (no "
            "torchrun environment: WORLD_SIZE, MASTER_ADDR); run under "
            "torchrun")
    if int(os.environ.get("WORLD_SIZE", "1")) == 1 and not initialize:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev
