"""Fixed-shape token-stream ops for interleaved image-text sequences
(counterpart of `mm_interleaved_tpu/models/stream_ops.py`).

Images arrive padded per sequence (``[B, max_img, ...]`` plus
``num_image_per_seq``); special-token positions and the "nearest <bos>"
relation are masked computations over those padded axes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def token_positions(text_ids: torch.Tensor, token_id: int,
                    max_count: int) -> torch.Tensor:
    """Position of the k-th occurrence of ``token_id`` per row:
    ``[B, max_count]`` int32, with the sentinel ``L`` where a row has fewer
    occurrences.  Occurrences beyond ``max_count`` are dropped."""
    B, L = text_ids.shape
    hit = text_ids == token_id
    k = torch.cumsum(hit.long(), dim=-1) - 1
    k = torch.where(hit & (k < max_count), k, torch.full_like(k, max_count))
    pos = torch.arange(L, dtype=torch.int32,
                       device=text_ids.device).expand(B, L)
    out = torch.full((B, max_count + 1), L, dtype=torch.int32,
                     device=text_ids.device)
    # only the overflow column receives duplicate writes, and it is dropped
    out.scatter_(1, k, pos)
    return out[:, :max_count]


def nearest_bos_positions(text_ids: torch.Tensor,
                          bos_token_id: int) -> torch.Tensor:
    """Index of the nearest preceding (or equal) <bos> per position; -1
    before the first <bos>."""
    B, L = text_ids.shape
    pos = torch.arange(L, dtype=torch.int32,
                       device=text_ids.device).expand(B, L)
    marked = torch.where(text_ids == bos_token_id, pos,
                         torch.full_like(pos, -1))
    return torch.cummax(marked, dim=1).values


def scatter_image_embeds(
    text_embeds: torch.Tensor,  # [B, L, C]
    text_ids: torch.Tensor,  # [B, L]
    vis_embed: torch.Tensor,  # [B, max_img, num_img_token, C]
    image_token_id: int,
) -> torch.Tensor:
    """Replace the j-th ``<image>`` embedding of a row with token
    ``j % num_img_token`` of image ``j // num_img_token``."""
    B, L, C = text_embeds.shape
    _, max_img, n_tok, _ = vis_embed.shape
    is_img = text_ids == image_token_id
    j = (torch.cumsum(is_img.long(), dim=-1) - 1).clamp(min=0)
    img_idx = (j // n_tok).clamp(0, max_img - 1)
    slot_idx = j % n_tok
    b_idx = torch.arange(B, device=text_ids.device)[:, None]
    gathered = vis_embed[b_idx, img_idx, slot_idx]  # [B, L, C]
    return torch.where(is_img[..., None], gathered.to(text_embeds.dtype),
                       text_embeds)


def add_soi_embeds(mm_embeds: torch.Tensor, text_ids: torch.Tensor,
                   soi_embed: torch.Tensor, soi_token_id: int) -> torch.Tensor:
    """Add the learned <soi> embedding at every <soi> position."""
    is_soi = (text_ids == soi_token_id)[..., None]
    return mm_embeds + is_soi.to(mm_embeds.dtype) * soi_embed[None, None, :]


def mm_cross_attention_mask(
    text_ids: torch.Tensor,
    num_image_per_seq: torch.Tensor,
    soi_token_id: int,
    bos_token_id: int,
    max_img: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token x per-image causal cross-attention mask: token t sees image
    k iff the image's first token (soi+1) lies in ``(nearest_bos(t), t]``
    and k is a real image of the row.

    Returns (mask ``[B, L, max_img]`` int32, soi_pos ``[B, max_img]``).
    """
    B, L = text_ids.shape
    dev = text_ids.device
    soi_pos = token_positions(text_ids, soi_token_id, max_img)
    img_pos = soi_pos + 1
    near_bos = nearest_bos_positions(text_ids, bos_token_id)
    t = torch.arange(L, dtype=torch.int32, device=dev)[None, :, None]
    ip = img_pos[:, None, :]
    k_valid = (
        torch.arange(max_img, dtype=torch.int32, device=dev)[None, None, :]
        < num_image_per_seq[:, None, None]
    )
    mask = (ip > near_bos[:, :, None]) & (ip <= t) & k_valid
    return mask.to(torch.int32), soi_pos


def context_windows(
    hidden: torch.Tensor,  # [B, L, C]
    soi_pos: torch.Tensor,  # [B, max_img]
    near_bos: torch.Tensor,  # [B, L]
    num_image_per_seq: torch.Tensor,  # [B]
    max_ctx: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image reversed context window: window j of image k is
    ``hidden[soi_pos_k - j]`` for ``j in [0, soi_pos_k - bos_k]`` (index 0
    is the <soi> token itself), zero elsewhere.

    Returns (ctx ``[B, max_img, max_ctx, C]``, mask ``[B, max_img,
    max_ctx]`` int32).
    """
    B, L, C = hidden.shape
    max_img = soi_pos.shape[1]
    dev = hidden.device
    soi = soi_pos.long()
    safe_soi = soi.clamp(0, L - 1)
    bos_at_soi = torch.gather(near_bos.long(), 1, safe_soi).clamp(min=0)
    ctx_len = safe_soi - bos_at_soi + 1
    j = torch.arange(max_ctx, device=dev)
    idx = safe_soi[:, :, None] - j[None, None, :]
    valid = ((j[None, None, :] < ctx_len[:, :, None])
             & (soi[:, :, None] < L)
             & (torch.arange(max_img, device=dev)[None, :, None]
                < num_image_per_seq[:, None, None]))
    idx = idx.clamp(0, L - 1)
    b_idx = torch.arange(B, device=dev)[:, None, None]
    ctx = hidden[b_idx, idx]  # [B, max_img, max_ctx, C]
    ctx = torch.where(valid[..., None], ctx, torch.zeros_like(ctx))
    return ctx, valid.to(torch.int32)


def previous_image_mask(
    soi_pos: torch.Tensor,  # [B, max_img]
    near_bos: torch.Tensor,  # [B, L]
    num_image_per_seq: torch.Tensor,  # [B]
    L: int,
) -> torch.Tensor:
    """``[B, max_img]`` int32: 1 where target image k has image k-1 in
    context (k-1 exists and its <soi> is at or after the nearest <bos> of
    image k's <soi>, the same packed document)."""
    B, max_img = soi_pos.shape
    soi = soi_pos.long()
    safe_soi = soi.clamp(0, L - 1)
    bos_at_soi = torch.gather(near_bos.long(), 1, safe_soi).clamp(min=0)
    prev_soi = torch.roll(soi, 1, dims=1)  # column 0 is invalid
    k = torch.arange(max_img, device=soi.device)[None, :]
    has_prev = (k >= 1) & (k < num_image_per_seq[:, None])
    in_doc = prev_soi >= bos_at_soi
    cur_valid = soi < L
    return (has_prev & in_doc & cur_valid & (prev_soi < L)).to(torch.int32)


def prepare_gt_text_ids(
    text_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    special,
    ignore_prompt_token_offset=0,
    ignore_noimage_cond_loss: bool = False,
) -> torch.Tensor:
    """Next-token labels ``[B, L-1]`` aligned with ``logits[:, :-1]``: -100
    on prompt offsets (an int or ``[B]``), pads, image placeholders,
    ``<bos>``, ``<bos>``->``<soi>`` transitions and, with
    ``ignore_noimage_cond_loss``, tokens with no preceding image in their
    document.  ``special`` is a `SpecialTokens`."""
    B, L = text_ids.shape
    dev = text_ids.device
    pos = torch.arange(L, device=dev)[None, :]
    offset = torch.as_tensor(ignore_prompt_token_offset, device=dev).long()
    if offset.dim() == 0:
        offset = offset.expand(B)
    ignore = torch.full_like(text_ids, -100)
    gt = torch.where(pos < offset[:, None], ignore, text_ids)
    if ignore_noimage_cond_loss:
        near_bos = nearest_bos_positions(text_ids, special.bos_token_id)
        near_bos = near_bos.clamp(min=0)
        marked = torch.where(text_ids == special.soi_token_id,
                             pos.expand(B, L), torch.full_like(text_ids, -1))
        near_soi = torch.cummax(marked, dim=1).values
        noimage = (near_soi < near_bos) | (near_soi == -1)
        gt = torch.where(noimage, ignore, gt)
    gt = gt[:, 1:]
    nxt = text_ids[:, 1:]
    drop = ((nxt == special.pad_token_id) | (nxt == special.image_token_id)
            | (attention_mask[:, 1:] == 0)
            | ((text_ids[:, :-1] == special.bos_token_id)
               & (nxt == special.soi_token_id))
            | (nxt == special.bos_token_id))
    return torch.where(drop, ignore[:, 1:], gt)


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -100) -> torch.Tensor:
    """Mean cross-entropy in fp32 over the positions whose label is not
    ``ignore_index`` (0 when there are none)."""
    valid = labels != ignore_index
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)
