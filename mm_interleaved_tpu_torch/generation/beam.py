"""Beam search over the LLM + text decoder with the preallocated KV cache
(counterpart of `mm_interleaved_tpu/generation/beam.py`, the reference's
patched HF beam search).

  * ``max(2, 1 + n_eos) * K`` candidates a step, so that K non-eos tokens
    always remain; finished hypotheses are pooled apart with HF's length
    penalty ``cum_logprob / len ** alpha``, ``len`` excluding the stopping
    eos (``lp_includes_eos`` counts it);
  * an eos candidate enters the pool only at rank < K among the step's
    candidates; an eos at step 0 is a 0-length hypothesis, divided by
    ``0 ** alpha`` as HF does (-inf for alpha > 0, the score for 0);
  * the last step merges the live beams, scored at the full length, into
    the pool; the best of the pool wins;
  * the output keeps the actual stopping token (``<eos>`` or ``<soi>``) and
    holds only the new tokens, pad after the first stop.

Every top-k is a stable descending sort, so ties (the pool is full of
``NEG_INF``) go to the lower index as in ``jax.lax.top_k``.  The prefill
runs on B rows; its cache, its MMFS value projections and the last row of
the cross mask are then tiled to B*K rows.  The projections are shared by
the beams of a row and never reordered; the cache is reordered every step
into a second buffer, and the two swap, so a step allocates no cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.llama import KVCache

NEG_INF = -1.0e7


def top_k(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def length_penalty(length: int, alpha: float, device) -> torch.Tensor:
    """``length ** alpha`` in fp32 (``0 ** 0`` is 1)."""
    return torch.tensor(float(length), dtype=torch.float32,
                        device=device).pow(alpha)


def gather_rows(ids: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """``ids [B, N, T]`` rows ``sel [B, M]`` -> ``[B, M, T]``."""
    return torch.gather(ids, 1, sel[:, :, None].expand(-1, -1, ids.shape[2]))


@torch.no_grad()
def beam_search(
    model,
    mm_embeds: torch.Tensor,  # [B, L, C]
    attention_mask: torch.Tensor,  # [B, L]
    mmfs_values: Optional[torch.Tensor],
    cross_attention_mask: Optional[torch.Tensor],  # [B, L, n_img]
    cfg,
) -> torch.Tensor:
    """The best hypothesis' new tokens, ``[B, max_new_tokens]``; ``cfg`` is
    a `generation.text.TextGenerationConfig`."""
    B, L, _ = mm_embeds.shape
    dev = mm_embeds.device
    K = cfg.num_beams
    T = cfg.max_new_tokens
    vocab = model.cfg.llm.vocab_size
    eos = torch.tensor(cfg.eos_token_ids, dtype=torch.long, device=dev)
    alpha = cfg.length_penalty
    C = max(2, 1 + len(cfg.eos_token_ids)) * K
    eos_len_off = 1 if cfg.lp_includes_eos else 0

    # the prefill on B rows, then its state tiled to B*K
    cache = KVCache.create(model.cfg.llm, B, L + T, device=dev,
                           dtype=model.soi_token.dtype,
                           kv_heads=model.mm_decoder.kv_heads)
    logits, _, cache, vision_values = model.lm_prefill(
        mm_embeds, attention_mask, mmfs_values, cross_attention_mask, cache
    )
    first_logp = torch.log_softmax(logits[:, -1].float(), dim=-1)  # [B, V]
    cache = cache.tile(K)
    spare = KVCache(torch.empty_like(cache.k), torch.empty_like(cache.v),
                    torch.empty_like(cache.valid), cache.length)
    vvc = [v.repeat_interleave(K, dim=0) for v in vision_values] or None
    mmfs_b = (mmfs_values.repeat_interleave(K, dim=0)
              if vvc is None and mmfs_values is not None else None)
    xmask_b = (cross_attention_mask[:, -1:, :].repeat_interleave(K, dim=0)
               if cross_attention_mask is not None else None)
    ones = torch.ones((B * K, 1), dtype=torch.int32, device=dev)
    rank_ok = torch.arange(C, device=dev)[None, :] < K
    row_base = torch.arange(B, device=dev)[:, None] * K

    def mask_eos(logp, step):
        if cfg.min_new_tokens <= 0 or step >= cfg.min_new_tokens:
            return logp
        logp = logp.clone()
        logp[..., eos] = NEG_INF
        return logp

    def neg_inf_like(x):
        return torch.full_like(x, NEG_INF)

    # step 0: the top C tokens of the first distribution; eos candidates of
    # rank < K enter the pool, the live beams are the top K non-eos
    scores0, tok0 = top_k(mask_eos(first_logp, 0), C)  # [B, C]
    is_eos0 = torch.isin(tok0, eos)
    cand_ids0 = torch.full((B, C, T), cfg.pad_token_id, dtype=torch.long,
                           device=dev)
    cand_ids0[:, :, 0] = tok0
    fin0 = torch.where(
        is_eos0 & rank_ok,
        scores0 / length_penalty(eos_len_off, alpha, dev),
        neg_inf_like(scores0))
    fin_scores, fin_sel = top_k(fin0, K)
    fin_ids = gather_rows(cand_ids0, fin_sel)
    live_scores, live_sel = top_k(
        torch.where(is_eos0, neg_inf_like(scores0), scores0), K)
    live_ids = gather_rows(cand_ids0, live_sel)

    for step in range(1, T):
        last = live_ids[:, :, step - 1].reshape(B * K, 1)
        step_logits, cache = model.lm_decode_step(
            last, ones, mmfs_b, xmask_b, cache, vvc)
        logp = torch.log_softmax(step_logits[:, 0].float(), dim=-1)
        logp = mask_eos(logp, step).reshape(B, K, vocab)

        cand = (live_scores[:, :, None] + logp).reshape(B, K * vocab)
        top_scores, top_idx = top_k(cand, C)  # [B, C]
        parent = top_idx // vocab
        token = top_idx % vocab
        is_eos = torch.isin(token, eos)
        cand_ids = gather_rows(live_ids, parent)
        cand_ids[:, :, step] = token

        # the pool: eos candidates of rank < K, divided by the length
        # without the eos (== step)
        new_fin = torch.where(
            is_eos & rank_ok,
            top_scores / length_penalty(step + eos_len_off, alpha, dev),
            neg_inf_like(top_scores))
        fin_scores, fin_sel = top_k(torch.cat([fin_scores, new_fin], 1), K)
        fin_ids = gather_rows(torch.cat([fin_ids, cand_ids], 1), fin_sel)

        # the live beams: the best K non-eos candidates; the cache follows
        # their parents
        live_scores, live_sel = top_k(
            torch.where(is_eos, neg_inf_like(top_scores), top_scores), K)
        live_ids = gather_rows(cand_ids, live_sel)
        live_parent = torch.gather(parent, 1, live_sel)
        cache, spare = cache.reorder((row_base + live_parent).reshape(-1),
                                     out=spare), cache

    # finalize: the live beams join the pool scored at the full length T
    live_final = live_scores / length_penalty(T, alpha, dev)
    pool_scores = torch.cat([fin_scores, live_final], 1)
    pool_ids = torch.cat([fin_ids, live_ids], 1)
    best = pool_scores.argmax(dim=1)
    out = pool_ids[torch.arange(B, device=dev), best]
    # everything after the first stop token becomes pad (the stop stays)
    hit = torch.isin(out, eos).long()
    after = (hit.cumsum(dim=1) - hit) > 0
    return torch.where(after, torch.full_like(out, cfg.pad_token_id), out)
