"""MMFS, the Multi-image Multi-scale Feature Synchronizer: the per-query
LLM branch (counterpart of `mm_interleaved_tpu/models/mmfs.py`).

Masked multi-image deformable cross-attention from the token stream onto
the feature pyramids of the images visible to each token.  As in the JAX
module:

  * the relpos embedding is applied by linearity: the offset and attention
    projections run once on the relpos table and are gathered per
    (query, image);
  * the softmax over ``n_img * n_levels * (n_points + 1)`` slots is
    factorised, with the ignore slots pinned at logit ``-log(n_img*L)``
    and a -80 clamp guarding the ignore mass;
  * the ignore token is folded through the output projection.

The JAX module reuses the value projection across decode steps by sowing
it; here `MMFS.forward` returns it beside the output and takes it back as
``projected_value``.  The UNet branch (per-image masks, the factorised
multi-image kernel) belongs to the image half of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from einops import rearrange

from ..ops.ms_deform_attn import ms_deform_attn_multi_image


def image_relpos_from_mask(mask: torch.Tensor,
                           max_images: int) -> torch.Tensor:
    """Per-(query,) image relative position: the most recent valid image
    gets the highest index, counting down; invalid images get 0."""
    num_tot = mask.sum(dim=-1, keepdim=True)
    num_prev = torch.cumsum(mask, dim=-1)
    relpos = (num_tot + 1 - num_prev) * mask
    return relpos.clamp(0, max_images - 1)


class MMFS(nn.Module):
    def __init__(
        self,
        d_model: int = 256,
        d_query: int = -1,
        d_value: int = 256,
        d_out: int = -1,
        n_heads: int = 8,
        n_points: int = 8,
        ratio: float = 1.0,
        offset_init_magnitude: float = 3.0,
        level_shapes: Sequence[Tuple[int, int]] = ((16, 16),),
        base_spatial_shape: int = 16,
        max_num_image_per_seq: int = 50,
    ):
        super().__init__()
        self.d_query = d_query if d_query > 0 else d_model
        self.d_out = d_out if d_out > 0 else d_model
        self.d_val_proj = int(d_model * ratio)
        self.n_heads = n_heads
        self.n_points = n_points
        self.offset_init_magnitude = offset_init_magnitude
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.base_spatial_shape = base_spatial_shape
        self.max_num_image_per_seq = max_num_image_per_seq
        L = len(self.level_shapes)
        H, P = n_heads, n_points
        self.value_proj = nn.Linear(d_value, self.d_val_proj)
        self.dynamic_offset_mask = nn.Linear(self.d_query, self.d_query)
        self.query_relpos = nn.Embedding(max_num_image_per_seq, self.d_query)
        self.sampling_offsets = nn.Linear(self.d_query, H * P * 2)
        self.attention_weights = nn.Linear(self.d_query, H * L * (P + 1))
        self.ignore_token = nn.Parameter(torch.empty(self.d_val_proj))
        self.output_proj = nn.Linear(self.d_val_proj, self.d_out)

    def init_weights(self, g: torch.Generator) -> None:
        w = self.query_relpos.weight.data
        w.normal_(0.0, 0.02, generator=g)
        w.clamp_(-0.04, 0.04)  # truncated normal at two stddevs
        self.sampling_offsets.weight.data.zero_()
        m = self.offset_init_magnitude
        self.sampling_offsets.bias.data.uniform_(-m, m, generator=g)
        self.attention_weights.bias.data.zero_()
        self.ignore_token.data.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, d_query]
        input_flatten: Optional[torch.Tensor],  # [B, n_img, hw, d_value]
        attention_mask: torch.Tensor,  # [B, Lq, n_img], 1 = valid
        projected_value: Optional[torch.Tensor] = None,  # [B, n_img, hw, d]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(out [B, Lq, d_out], projected_value)``; pass the
        second back on decode steps to skip the value projection."""
        if attention_mask.dim() != 3:
            raise NotImplementedError(
                "MMFS: only the per-query (LLM) mask [B, Lq, n_img] is ported"
            )
        n_levels = len(self.level_shapes)
        B, Lq, _ = query.shape
        n_img = attention_mask.shape[-1]
        P, H = self.n_points, self.n_heads
        R = self.max_num_image_per_seq
        dev = query.device

        mask = attention_mask.long()
        image_relpos = image_relpos_from_mask(mask, R)  # [B, Lq, n_img]

        if projected_value is None:
            projected_value = self.value_proj(input_flatten)
        value = projected_value.reshape(B, n_img, -1, H, self.d_val_proj // H)

        q = self.dynamic_offset_mask(query)
        emb_mat = self.query_relpos.weight  # [R, d_query]
        zero_row = torch.zeros((1, self.d_query), dtype=emb_mat.dtype,
                               device=dev)
        off_q = self.sampling_offsets(q)
        off_tab = self.sampling_offsets(emb_mat) - self.sampling_offsets(zero_row)
        logit_q = self.attention_weights(q)
        logit_tab = (self.attention_weights(emb_mat)
                     - self.attention_weights(zero_row))

        lq = logit_q.reshape(B, Lq, H, n_levels, P + 1)[..., :P].float()
        lt = logit_tab.reshape(R, H, n_levels, P + 1)[..., :P].float()
        m_q = lq.amax(dim=(-2, -1))  # [B, Lq, H]
        m_t = lt.amax(dim=(0, -2, -1))  # [H]
        Eq = torch.exp(lq - m_q[..., None, None])
        Et = torch.exp(lt - m_t[None, :, None, None])

        m_sum = m_q + m_t[None, None, :]
        mc = m_sum.clamp(min=-80.0)  # overflow guard on the ignore mass
        point_scale = torch.exp(m_sum - mc)
        ignore_mass = torch.exp(-mc)

        off_q_r = off_q.float().reshape(B, Lq, H, P, 2)
        off_tab_r = off_tab.float().reshape(R, H, P, 2)

        per_level = torch.tensor(
            [[w / self.base_spatial_shape / w, h / self.base_spatial_shape / h]
             for (h, w) in self.level_shapes],
            dtype=torch.float32, device=dev,
        )
        # the LLM branch samples around the fixed reference (0.5, 0.5)
        ref = torch.full((B, Lq, 2), 0.5, dtype=torch.float32, device=dev)

        Et_g = Et[image_relpos] * mask[..., None, None, None].float()
        S = torch.einsum("bqhlp,bqnhlp->bqhn", Eq, Et_g)
        off_full = off_q_r[:, :, None] + off_tab_r[image_relpos]
        Et_b = rearrange(Et_g, "b q n h l p -> b q h n l p")
        off_b = rearrange(off_full, "b q n h p t -> b q h n p t")

        Z = S.sum(dim=-1) * point_scale + ignore_mass
        rZ = point_scale / Z
        w_ignore_tot = ignore_mass / Z

        w_points = Eq[:, :, :, None] * Et_b * rZ[:, :, :, None, None, None]
        sampling_locations = (
            ref[:, :, None, None, None, None, :]
            + off_b[:, :, :, :, None, :, :]
            * per_level[None, None, None, None, :, None, :]
        )
        out = ms_deform_attn_multi_image(
            value,
            self.level_shapes,
            sampling_locations.to(value.dtype),
            w_points.to(value.dtype),
        )
        out = self.output_proj(out)

        # folded ignore path: token_h in head h's slot, projected bias-free
        ignore_heads = self.ignore_token.float().reshape(H, -1)
        tok = (torch.eye(H, dtype=torch.float32, device=dev)[:, :, None]
               * ignore_heads[:, None, :]).reshape(H, self.d_val_proj)
        tok = tok.to(out.dtype)
        tok_w = self.output_proj(tok) - self.output_proj(torch.zeros_like(tok[:1]))
        out = out + torch.einsum("bqh,ho->bqo", w_ignore_tot.to(tok_w.dtype),
                                 tok_w)
        return out, projected_value
