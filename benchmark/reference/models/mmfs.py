"""MMFS, the Multi-image Multi-scale Feature Synchronizer (counterpart of
`mm_interleaved_tpu/models/mmfs.py`).

Masked multi-image deformable cross-attention from a query stream onto
the feature pyramids of the images visible to it.  As in the JAX module:

  * the relpos embedding is applied by linearity: the offset and attention
    projections run once on the relpos table and are gathered per
    (query, image);
  * the softmax over ``n_img * n_levels * (n_points + 1)`` slots is
    factorised, with the ignore slots pinned at logit ``-log(n_img*L)``
    and a -80 clamp guarding the ignore mass;
  * the ignore token is folded through the output projection.

Two branches, chosen by whether `forward` is given an image side:

  * the LLM branch, a per-query mask ``[B, Lq, n_img]``: the wide
    locations and weights go to `ms_deform_attn_multi_image`.  `forward`
    returns the value projection beside the output and takes it back as
    ``projected_value`` on decode steps;
  * the UNet branch, a per-image mask ``[Bv, n_img]``: the image side
    (`image_side`: the value, the masked image weight factor and the delta
    table) depends on the weights and the mask alone, may be computed once
    for a denoise loop, and may carry a smaller batch than the queries
    (query row ``c * Bv + b`` reads image row ``b``, the CFG halves).  The
    readout is the factorised kernel of `ops.ms_deform_attn_mi`; the query
    weight factor ``Eq * rZ`` is cast to the value dtype before it, as in
    the JAX package.  That kernel is forward only, as the JAX one serves
    inference traces alone: a call that autograd records takes the JAX
    package's non-factorised route instead (``off_q + off_img`` and the
    wide weights ``Eq * Et * rZ`` through `ms_deform_attn_multi_image`, the
    differentiable deformable op).

The head count and the value width are read from the projections'
widths: an MMFS cut over ``tensor`` (`parallel.tensor`; the LLM's and
MMFSNet's alike) holds this rank's heads, sums its output projection over
``tensor_group`` and adds the bias once, after the sum.  In the UNet branch
the image side (the value, ``Et_g``, the offsets and the delta table) then
holds the local heads.  In training the inputs of its column-parallel
projections (the value, the offset/mask query and the relpos table) pass
`parallel.tensor.tensor_enter`, so their gradients are summed over the
heads of every rank; ``dynamic_offset_mask`` stays whole.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from einops import rearrange

from ..ops.cuda_build import needs_grad
from ..ops.ms_deform_attn import ms_deform_attn_multi_image
from ..ops.ms_deform_attn_mi import build_delta, mmfs_deform_factorized
from ..parallel.tensor import partial_dtype, tensor_all_reduce, tensor_enter


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
        d_val_proj = int(d_model * ratio)
        self.n_points = n_points
        self.offset_init_magnitude = offset_init_magnitude
        self.level_shapes = tuple(tuple(s) for s in level_shapes)
        self.base_spatial_shape = base_spatial_shape
        self.max_num_image_per_seq = max_num_image_per_seq
        L = len(self.level_shapes)
        H, P = n_heads, n_points
        self.value_proj = nn.Linear(d_value, d_val_proj)
        self.dynamic_offset_mask = nn.Linear(self.d_query, self.d_query)
        self.query_relpos = nn.Embedding(max_num_image_per_seq, self.d_query)
        self.sampling_offsets = nn.Linear(self.d_query, H * P * 2)
        self.attention_weights = nn.Linear(self.d_query, H * L * (P + 1))
        self.ignore_token = nn.Parameter(torch.empty(d_val_proj))
        self.output_proj = nn.Linear(d_val_proj, self.d_out)
        self.tensor_group = None

    def tensor_pairs(self):
        return (("tensor_group", self.n_heads,
                 ("value_proj", "sampling_offsets", "attention_weights",
                  "ignore_token", "output_proj")),)

    @property
    def n_heads(self) -> int:
        """The heads this module holds (all, or this rank's)."""
        return self.sampling_offsets.out_features // (2 * self.n_points)

    @property
    def d_val_proj(self) -> int:
        return self.value_proj.out_features

    def init_weights(self, g: torch.Generator) -> None:
        w = self.query_relpos.weight.data
        w.normal_(0.0, 0.02, generator=g)
        w.clamp_(-0.04, 0.04)  # truncated normal at two stddevs
        self.sampling_offsets.weight.data.zero_()
        m = self.offset_init_magnitude
        self.sampling_offsets.bias.data.uniform_(-m, m, generator=g)
        self.attention_weights.bias.data.zero_()
        self.ignore_token.data.zero_()

    def _tables(self):
        """Weight-only relpos tables: the offsets ``[R, H, P, 2]`` and the
        exp-logits ``Et [R, H, L, P]`` of the relpos embedding (bias-free,
        ``Dense(x) - Dense(0)``), and the logit max ``m_t [H]``."""
        H, P, R = self.n_heads, self.n_points, self.max_num_image_per_seq
        L = len(self.level_shapes)
        emb_mat = tensor_enter(self.query_relpos.weight,  # [R, d_query]
                               self.tensor_group)
        zero_row = torch.zeros((1, self.d_query), dtype=emb_mat.dtype,
                               device=emb_mat.device)
        off_tab = (self.sampling_offsets(emb_mat)
                   - self.sampling_offsets(zero_row))
        logit_tab = (self.attention_weights(emb_mat)
                     - self.attention_weights(zero_row))
        lt = logit_tab.reshape(R, H, L, P + 1)[..., :P].float()
        m_t = lt.amax(dim=(0, -2, -1))  # [H]
        Et = torch.exp(lt - m_t[None, :, None, None])
        return off_tab.float().reshape(R, H, P, 2), Et, m_t

    def image_side(self, attention_mask: torch.Tensor,
                   projected_value: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The UNet branch's query-independent inputs for an image mask
        ``[Bv, n_img]`` and the projected value ``[Bv, n_img, hw, d]``."""
        mask = attention_mask.long()
        Bv, n_img = mask.shape
        relpos = image_relpos_from_mask(mask, self.max_num_image_per_seq)
        off_tab, Et, m_t = self._tables()
        Et_g = Et[relpos] * mask[..., None, None, None].float()
        off_img = off_tab[relpos]  # [Bv, n_img, H, P, 2]
        H = self.n_heads
        return dict(
            value=projected_value.reshape(Bv, n_img, -1, H,
                                          self.d_val_proj // H),
            Et_g=Et_g,  # [Bv, n_img, H, L, P]
            off_img=off_img,
            delta=build_delta(off_img, Et_g, self.level_shapes,
                              1.0 / self.base_spatial_shape),
            m_t=m_t,
        )

    def _ignore_table(self, out_dtype, dev):
        """Folded ignore path: token_h in head h's slot, projected
        bias-free, ``[H, d_out]``."""
        H = self.n_heads
        ignore_heads = self.ignore_token.float().reshape(H, -1)
        tok = (torch.eye(H, dtype=torch.float32, device=dev)[:, :, None]
               * ignore_heads[:, None, :]).reshape(H, self.d_val_proj)
        tok = tok.to(out_dtype)
        if self.tensor_group is not None:
            # the bias is added once, after the sum over tensor
            return F.linear(tok, self.output_proj.weight.to(out_dtype))
        return (self.output_proj(tok)
                - self.output_proj(torch.zeros_like(tok[:1])))

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, d_query]
        input_flatten: Optional[torch.Tensor],  # [B, n_img, hw, d_value]
        attention_mask: Optional[torch.Tensor],  # [B, Lq, n_img]
        reference_points: Optional[torch.Tensor] = None,  # [B, Lq, 2]
        projected_value: Optional[torch.Tensor] = None,  # [B, n_img, hw, d]
        image_side: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns ``(out [B, Lq, d_out], projected_value)``; pass the
        second back on decode steps to skip the value projection.  The UNet
        branch passes ``image_side`` (from `image_side`) in place of the
        value and the mask."""
        if image_side is not None:
            return self._forward_image_mask(query, reference_points,
                                            image_side), None
        if projected_value is None:
            projected_value = self.value_proj(
                tensor_enter(input_flatten, self.tensor_group))
        return self._forward_query_mask(query, attention_mask,
                                        projected_value), projected_value

    def _query_logits(self, query):
        B, Lq, _ = query.shape
        H, P = self.n_heads, self.n_points
        L = len(self.level_shapes)
        q = tensor_enter(self.dynamic_offset_mask(query), self.tensor_group)
        off_q = self.sampling_offsets(q).float().reshape(B, Lq, H, P, 2)
        lq = self.attention_weights(q).reshape(B, Lq, H, L, P + 1)[..., :P]
        lq = lq.float()
        m_q = lq.amax(dim=(-2, -1))  # [B, Lq, H]
        Eq = torch.exp(lq - m_q[..., None, None])
        return off_q, Eq, m_q

    @staticmethod
    def _norms(m_q, m_t, S):
        """(rZ, w_ignore) from the logit maxima and the point mass ``S``."""
        m_sum = m_q + m_t[None, None, :]
        mc = m_sum.clamp(min=-80.0)  # overflow guard on the ignore mass
        point_scale = torch.exp(m_sum - mc)
        ignore_mass = torch.exp(-mc)
        Z = S.sum(dim=-1) * point_scale + ignore_mass
        return point_scale / Z, ignore_mass / Z

    def _wide_readout(self, value, Eq, Et_b, off_b, rZ, ref):
        """The non-factorised readout: per-(query, image) locations and
        weights through `ms_deform_attn_multi_image`.  ``Et_b [B, Lq or 1,
        H, n_img, L, P]``, ``off_b [B, Lq, H, n_img, P, 2]``."""
        per_level = torch.tensor(
            [[w / self.base_spatial_shape / w, h / self.base_spatial_shape / h]
             for (h, w) in self.level_shapes],
            dtype=torch.float32, device=Eq.device,
        )
        w_points = Eq[:, :, :, None] * Et_b * rZ[:, :, :, None, None, None]
        sampling_locations = (
            ref[:, :, None, None, None, None, :]
            + off_b[:, :, :, :, None, :, :]
            * per_level[None, None, None, None, :, None, :]
        )
        return ms_deform_attn_multi_image(
            value,
            self.level_shapes,
            sampling_locations.to(value.dtype),
            w_points.to(value.dtype),
        )

    def _finish(self, out, w_ignore_tot):
        """The output projection with the folded ignore path; cut over
        ``tensor``, this rank's partial (in `parallel.tensor.partial_dtype`)
        summed over the group, the bias added once after the sum."""
        proj = self.output_proj
        dtype = out.dtype
        if self.tensor_group is None:
            out = proj(out)
        else:
            out = out.to(partial_dtype(dtype))
            out = F.linear(out, proj.weight.to(out.dtype))
        tok_w = self._ignore_table(out.dtype, out.device)
        out = out + torch.einsum("bqh,ho->bqo", w_ignore_tot.to(tok_w.dtype),
                                 tok_w)
        if self.tensor_group is None:
            return out
        out = tensor_all_reduce(out, self.tensor_group)
        return (out + proj.bias.to(out.dtype)).to(dtype)

    def _forward_image_mask(self, query, reference_points, side):
        B, Lq, _ = query.shape
        Et_g = side["Et_g"]
        Bv = Et_g.shape[0]
        if B % Bv:
            raise ValueError(f"query batch {B} is not a multiple of the "
                             f"image batch {Bv}")
        off_q, Eq, m_q = self._query_logits(query)
        rep = B // Bv
        S = torch.einsum("bqhlp,bnhlp->bqhn", Eq, Et_g.repeat(rep, 1, 1, 1, 1))
        rZ, w_ignore_tot = self._norms(m_q, side["m_t"], S)
        if reference_points is None:
            ref = torch.full((B, Lq, 2), 0.5, dtype=torch.float32,
                             device=query.device)
        else:
            ref = reference_points.float()
        value = side["value"]
        if needs_grad(off_q, Eq, value, Et_g, side["off_img"]):
            off_img = side["off_img"].repeat(rep, 1, 1, 1, 1)
            off_full = off_q[:, :, None] + off_img[:, None]
            out = self._wide_readout(
                value.repeat(rep, 1, 1, 1, 1), Eq,
                rearrange(Et_g.repeat(rep, 1, 1, 1, 1),
                          "b n h l p -> b () h n l p"),
                rearrange(off_full, "b q n h p t -> b q h n p t"), rZ, ref)
        else:
            out = mmfs_deform_factorized(
                value, side["delta"], self.level_shapes, ref, off_q,
                (Eq * rZ[..., None, None]).to(value.dtype),
                1.0 / self.base_spatial_shape,
            )
        return self._finish(out, w_ignore_tot)

    def _forward_query_mask(self, query, attention_mask, projected_value):
        B, Lq, _ = query.shape
        n_img = attention_mask.shape[-1]
        P, H = self.n_points, self.n_heads
        dev = query.device

        mask = attention_mask.long()
        image_relpos = image_relpos_from_mask(
            mask, self.max_num_image_per_seq)  # [B, Lq, n_img]
        value = projected_value.reshape(B, n_img, -1, H, self.d_val_proj // H)
        off_q_r, Eq, m_q = self._query_logits(query)
        off_tab_r, Et, m_t = self._tables()
        # the LLM branch samples around the fixed reference (0.5, 0.5)
        ref = torch.full((B, Lq, 2), 0.5, dtype=torch.float32, device=dev)

        Et_g = Et[image_relpos] * mask[..., None, None, None].float()
        S = torch.einsum("bqhlp,bqnhlp->bqhn", Eq, Et_g)
        off_full = off_q_r[:, :, None] + off_tab_r[image_relpos]
        rZ, w_ignore_tot = self._norms(m_q, m_t, S)
        out = self._wide_readout(
            value, Eq, rearrange(Et_g, "b q n h l p -> b q h n l p"),
            rearrange(off_full, "b q n h p t -> b q h n p t"), rZ, ref)
        return self._finish(out, w_ignore_tot)
