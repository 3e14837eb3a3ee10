"""Option ranking, `generate_scores` (counterpart of
`mm_interleaved_tpu/generation/scores.py`).

For each context and candidate option, the cache-free forward of the LLM
and the text decoder, and the sum of the option tokens' log-probabilities;
VisDial's NDCG ranks by it.  The options fold into the batch axis, which
runs in chunks of ``mini_bs`` rows to bound the peak memory.  The tail
chunk runs at its own size: there is no recompile to avoid.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.inference_mode()
def generate_scores(
    model,
    text_ids: torch.Tensor,  # [B, L] shared context
    options_ids: torch.Tensor,  # [B, n_opt, Lo]
    options_mask: torch.Tensor,  # [B, n_opt, Lo] 1 = real option token
    image_tensors: torch.Tensor,  # [B, max_img, H, W, 3]
    num_image_per_seq: torch.Tensor,  # [B]
    attention_mask: torch.Tensor,  # [B, L]
    mini_bs: int = 4,
) -> np.ndarray:
    """Returns ``[B, n_opt]`` option log-prob scores (fp32)."""
    B, L = text_ids.shape
    n_opt, Lo = options_ids.shape[1], options_ids.shape[2]
    full_ids = torch.cat(
        [text_ids[:, None].expand(B, n_opt, L), options_ids.to(text_ids.dtype)],
        dim=2).reshape(B * n_opt, L + Lo)
    full_mask = torch.cat(
        [attention_mask[:, None].expand(B, n_opt, L),
         options_mask.to(attention_mask.dtype)],
        dim=2).reshape(B * n_opt, L + Lo)
    imgs = image_tensors.repeat_interleave(n_opt, dim=0)
    n_img = num_image_per_seq.repeat_interleave(n_opt, dim=0)

    scores = []
    total = B * n_opt
    step = max(1, mini_bs)
    for i in range(0, total, step):
        ids, mask = full_ids[i:i + step], full_mask[i:i + step]
        prep = model.prepare_mm_embeds(ids, imgs[i:i + step],
                                       n_img[i:i + step])
        hidden, _, _ = model.mm_decoder(
            prep["mm_embeds"], attention_mask=mask,
            vision_hidden_states=prep["mmfs_values"],
            cross_attention_mask=prep["cross_attention_mask"],
        )
        logits = model.text_decoder(hidden)
        # option token t (position L+t) is predicted at position L+t-1
        logp = torch.log_softmax(logits[:, L - 1:L + Lo - 1].float(), dim=-1)
        tok_logp = torch.gather(logp, 2, ids[:, L:L + Lo, None].long())[..., 0]
        scores.append((tok_logp * mask[:, L:L + Lo].float()).sum(dim=-1))
    return torch.cat(scores).cpu().numpy().reshape(B, n_opt)
