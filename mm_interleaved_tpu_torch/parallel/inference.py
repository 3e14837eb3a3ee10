"""The generation runtime (counterpart of the local half of
`mm_interleaved_tpu/parallel/inference.py`).

`LocalGenerator` keeps every generation call of the evaluator and the
interleaved inference loop behind one seam, with the surface of the JAX
package's `LocalGenerator` and `ShardedGenerator`: `generate_texts`,
`generate_image_inputs`, `denoise`, `generate_images` and
`generate_scores`.  The model holds its weights, so no variables are
passed.  `denoise` also takes ``latents`` and ``noises`` to inject draws.
``quantize="int8"`` replaces the LLM's projections by int8 ones in place
before the first call (`ops.quant.quantize_llm_weights`, as the JAX
`LocalGenerator.__init__` quantizes its variables), so every generation
call of the model (text, beam, scores and the image-prefix forward) runs
the quantized LLM.

The port runs on one device: a ``mesh:`` stanza over more than one device
(the sharded runtime, ROADMAP.md §1 item 6) is refused.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..generation.diffusion import generate_images
from ..generation.scores import generate_scores
from ..generation.text import TextGenerationConfig, generate_texts
from ..ops.quant import quantize_llm_weights

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


def mesh_size(mesh_cfg: Optional[Dict[str, Any]]) -> int:
    """The devices a ``mesh:`` stanza asks for (its axes' product; an
    axis of -1, "the rest", counts as 1 on one device)."""
    size = 1
    for axis in ("data", "fsdp", "tensor"):
        size *= max(1, int((mesh_cfg or {}).get(axis, 1)))
    return size


def check_quantize(quantize: Optional[str]) -> None:
    """An unknown ``quantize`` mode raises `ValueError`, as in the JAX
    runtimes."""
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r}")


def check_runtime(mesh_cfg=None, quantize: Optional[str] = None) -> None:
    """Refuse what the runtime cannot do (before any model is built): an
    unknown ``quantize`` mode, and a ``mesh:`` stanza over more than one
    device (the JAX package's `ShardedGenerator`, ROADMAP.md §1 item 6)."""
    check_quantize(quantize)
    if mesh_size(mesh_cfg) > 1:
        raise NotImplementedError(
            f"mesh {dict(mesh_cfg)} asks for more than one device; the "
            "sharded runtime is not ported yet (ROADMAP.md §1 item 6)")


def build_generation_runtime(model, mesh_cfg=None,
                             quantize: Optional[str] = None) -> LocalGenerator:
    """The entry points' factory, after `check_runtime`; ``quantize`` is
    applied to ``model`` in place."""
    check_runtime(mesh_cfg, quantize)
    return LocalGenerator(model, quantize=quantize)
