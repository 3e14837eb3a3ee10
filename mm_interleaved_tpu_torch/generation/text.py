"""Text generation: prefill with a preallocated KV cache, then a fixed
number of decode steps (counterpart of `mm_interleaved_tpu/generation/text.py`).

  * decode steps use the last prompt row of the per-token image-visibility
    mask, and reuse the prefill's MMFS value projections;
  * stopping on any of ``eos_token_ids``; the result holds only the new
    tokens, padded with ``pad_token_id`` after the first stop token;
  * greedy or temperature/nucleus sampling (uniforms drawn at once from a
    `torch.Generator`, or given, each row's CDF inverted at its own), the
    repetition penalty on generated tokens only, and the eos mask before
    ``min_new_tokens``; ``num_beams > 1`` routes to the beam search of
    :mod:`.beam`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..models.llama import KVCache
from .beam import beam_search


@dataclasses.dataclass(frozen=True)
class TextGenerationConfig:
    max_new_tokens: int = 30
    min_new_tokens: int = 0
    do_sample: bool = False
    top_p: float = 0.9
    temperature: float = 1.0
    repetition_penalty: float = 1.0
    num_beams: int = 1
    length_penalty: float = 1.0
    # transformers 4.31 (the reference's pinned version) divides a finished
    # hypothesis' score by its length *excluding* the stopping eos;
    # transformers >= 4.49 divides by the length *including* it.  The
    # default reproduces the reference.
    lp_includes_eos: bool = False
    eos_token_ids: Tuple[int, ...] = (2,)
    pad_token_id: int = 0


def apply_repetition_penalty(logits, presence, penalty: float):
    """HF semantics: for tokens already generated, positive logits are
    divided by the penalty and negative ones multiplied."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence, penalized, logits)


def mask_eos_before_min(logits, new_len: int, cfg: TextGenerationConfig):
    if cfg.min_new_tokens <= 0 or new_len >= cfg.min_new_tokens:
        return logits
    logits = logits.clone()
    logits[:, list(cfg.eos_token_ids)] = torch.finfo(logits.dtype).min
    return logits


def sample_uniforms(cfg: TextGenerationConfig, batch: int,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Nucleus sampling's draws, one uniform a step and row, ``[steps,
    batch]``, made at once at the global batch: a shard of the batch takes
    its columns of the same draws (`parallel.inference.ShardedGenerator`)."""
    return torch.rand((cfg.max_new_tokens, batch), generator=generator,
                      device=device)


def sample_token(logits, cfg: TextGenerationConfig,
                 generator: Optional[torch.Generator] = None,
                 u: Optional[torch.Tensor] = None):
    """logits: [B, V] fp32 -> [B] int64.  Sampling inverts each row's CDF
    at its uniform ``u [B]`` (drawn from ``generator`` when not given)."""
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep tokens until the cumulative probability passes top_p; the
        # top-1 token always stays
        cutoff_mask = cum - probs > cfg.top_p
        cutoff_logit = torch.where(
            cutoff_mask, torch.full_like(sorted_logits, float("inf")),
            sorted_logits,
        ).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff_logit,
                             torch.full_like(logits, torch.finfo(logits.dtype).min),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    if u is None:
        u = torch.rand(probs.shape[0], generator=generator,
                       device=probs.device)
    cdf = probs.cumsum(dim=-1)
    # the first token whose CDF passes u * total: never one of mass 0
    tok = torch.searchsorted(cdf, (u.to(cdf.dtype) * cdf[:, -1])[:, None],
                             right=True)[:, 0]
    return tok.clamp_(max=probs.shape[-1] - 1)


@torch.no_grad()
def generate_tokens(
    model,
    mm_embeds: torch.Tensor,  # [B, L, C]
    attention_mask: torch.Tensor,  # [B, L]
    mmfs_values: Optional[torch.Tensor],
    cross_attention_mask: Optional[torch.Tensor],  # [B, L, n_img]
    cfg: TextGenerationConfig,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,  # [max_new_tokens, B]
) -> torch.Tensor:
    """Greedy or nucleus decoding; returns ``[B, max_new_tokens]``.
    Sampling reads ``uniforms`` (`sample_uniforms`), drawn from
    ``generator`` when not given."""
    B, L, _ = mm_embeds.shape
    dev = mm_embeds.device
    vocab = model.cfg.llm.vocab_size
    if cfg.do_sample and uniforms is None:
        uniforms = sample_uniforms(cfg, B, generator, dev)
    cache = KVCache.create(model.cfg.llm, B, L + cfg.max_new_tokens,
                           device=dev, dtype=model.soi_token.dtype,
                           kv_heads=model.mm_decoder.kv_heads)
    logits, _, cache, vision_values = model.lm_prefill(
        mm_embeds, attention_mask, mmfs_values, cross_attention_mask, cache
    )
    vision_value_cache = vision_values or None
    decode_cross_mask = (cross_attention_mask[:, -1:, :]
                         if cross_attention_mask is not None else None)
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=dev)
    presence = torch.zeros((B, vocab), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    ones = torch.ones((B, 1), dtype=torch.int32, device=dev)

    def pick(step_logits, new_len):
        step_logits = apply_repetition_penalty(
            step_logits.float(), presence, cfg.repetition_penalty
        )
        step_logits = mask_eos_before_min(step_logits, new_len, cfg)
        return sample_token(step_logits, cfg,
                            u=None if uniforms is None else uniforms[new_len])

    tok = pick(logits[:, -1], 0)
    finished = torch.isin(tok, eos)
    presence[rows, tok] = True
    out = [tok]
    for new_len in range(1, cfg.max_new_tokens):
        step_logits, cache = model.lm_decode_step(
            tok[:, None], ones,
            None if vision_value_cache is not None else mmfs_values,
            decode_cross_mask, cache, vision_value_cache,
        )
        nxt = pick(step_logits[:, 0], new_len)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id), nxt)
        finished = finished | torch.isin(nxt, eos)
        presence[rows, nxt] = True
        out.append(nxt)
        tok = nxt
    out = torch.stack(out, dim=1)
    # everything after the first stop token becomes pad (the stop stays)
    hit = torch.isin(out, eos).long()
    after = (hit.cumsum(dim=1) - hit) > 0
    return torch.where(after, torch.full_like(out, cfg.pad_token_id), out)


@torch.no_grad()
def generate_texts(
    model,
    text_ids: torch.Tensor,
    image_tensors: torch.Tensor,
    num_image_per_seq: torch.Tensor,
    attention_mask: Optional[torch.Tensor] = None,
    cfg: TextGenerationConfig = TextGenerationConfig(),
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Encode the images, scatter them into the prompt, decode new tokens
    (``uniforms``: `generate_tokens`'s)."""
    if attention_mask is None:
        attention_mask = (text_ids != model.cfg.special.pad_token_id).int()
    prep = model.prepare_mm_embeds(text_ids, image_tensors, num_image_per_seq)
    if cfg.num_beams > 1:
        return beam_search(
            model, prep["mm_embeds"], attention_mask, prep["mmfs_values"],
            prep["cross_attention_mask"], cfg,
        )
    return generate_tokens(
        model, prep["mm_embeds"], attention_mask, prep["mmfs_values"],
        prep["cross_attention_mask"], cfg, generator, uniforms,
    )
