"""UNet-side MMFS (counterpart of `mm_interleaved_tpu/models/sd/mmfs_net.py`):
a deformable readout of the previous image's ViT pyramid, added to every
UNet down-block residual and to the mid-block sample.

The JAX denoise loop reaches each block's value projection through a pass
with dummy queries; here `MMFSNet.project_values` returns them, and
`MMFSNet.prepare` the whole image side of every block (see `models.mmfs`),
so the loop computes both once.  Cut over ``tensor``, each block's MMFS
holds this rank's heads (see `models.mmfs`), its image side too.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ...ops.pos_embed import resized_sincos_table
from ...parallel.tensor import tensor_enter
from ..deform_attn import grid_reference_points
from ..mmfs import MMFS


@dataclasses.dataclass(frozen=True)
class MMFSNetConfig:
    input_channel: int = 1024  # ViT pyramid channel dim
    attn_dim: int = 1024
    n_heads: int = 16
    n_points: int = 8
    feat_spatial_shapes: Tuple[int, ...] = (64, 32, 16, 8)
    max_num_image_per_seq: int = 10
    pos_grid_size: int = 64  # latent resolution the pos table is built for


class MMFSBlock(nn.Module):
    """One readout: the query is a UNet feature map (LayerNorm + the 2-D
    sin-cos table resized to its grid), the output goes through a
    zero-initialised 1x1 conv back to the query width."""

    def __init__(self, cfg: MMFSNetConfig, query_dim: int,
                 base_spatial_shape: int):
        super().__init__()
        self.cfg = cfg
        self.query_norm = nn.LayerNorm(query_dim, eps=1e-6)
        self.feat_norm = nn.LayerNorm(cfg.input_channel, eps=1e-6)
        self.mmfs = MMFS(
            d_model=cfg.attn_dim,
            d_query=query_dim,
            d_value=cfg.input_channel,
            d_out=query_dim,
            n_heads=cfg.n_heads,
            n_points=cfg.n_points,
            ratio=1.0,
            offset_init_magnitude=1.0,
            level_shapes=tuple((s, s) for s in cfg.feat_spatial_shapes),
            base_spatial_shape=base_spatial_shape,
            max_num_image_per_seq=cfg.max_num_image_per_seq,
        )
        self.conv = nn.Conv2d(query_dim, query_dim, 1)
        self._pe = {}  # (size, device, dtype) -> the resized table

    def _pos_embed(self, size: int, like: torch.Tensor) -> torch.Tensor:
        key = (size, like.device, like.dtype)
        if key not in self._pe:
            pe = resized_sincos_table(like.shape[-1], self.cfg.pos_grid_size,
                                      size)
            self._pe[key] = torch.from_numpy(pe).to(like.device, like.dtype)
        return self._pe[key]

    def init_weights(self, g: torch.Generator) -> None:
        self.conv.weight.data.zero_()
        self.conv.bias.data.zero_()

    def project_value(self, mmfs_values: torch.Tensor) -> torch.Tensor:
        """The value projection (this rank's heads where it is cut over
        ``tensor``)."""
        return self.mmfs.value_proj(tensor_enter(
            self.feat_norm(mmfs_values), self.mmfs.tensor_group))

    def prepare(self, mmfs_values: torch.Tensor, mmfs_mask: torch.Tensor):
        """The image side of ``mmfs_values [Bv, n_img, sum(hw), Cv]`` and
        ``mmfs_mask [Bv, n_img]`` (see `MMFS.image_side`)."""
        return self.mmfs.image_side(mmfs_mask, self.project_value(mmfs_values))

    def forward(self, sample, image_side):
        """sample ``[B, H, W, Cq]`` with ``B`` a multiple of the image
        side's batch ``Bv``; ``image_side`` from `prepare`."""
        B, H, W, Cq = sample.shape
        q = self.query_norm(sample.reshape(B, H * W, Cq))
        q = q + self._pos_embed(H, q)[None]
        ref = torch.from_numpy(grid_reference_points(((H, W),))).to(
            sample.device)[None].expand(B, H * W, 2)
        out, _ = self.mmfs(q, None, None, reference_points=ref,
                           image_side=image_side)
        w = self.conv.weight[:, :, 0, 0].to(out.dtype)
        out = F.linear(out, w, self.conv.bias.to(out.dtype))  # the 1x1 conv
        return out.reshape(B, H, W, Cq)


class MMFSNet(nn.Module):
    """One `MMFSBlock` per UNet down-block residual (``down_blocks_{i}``)
    and one for the mid sample (``mid_block``)."""

    def __init__(self, cfg: MMFSNetConfig, residual_channels: Sequence[int],
                 residual_sizes: Sequence[int], mid_channel: int,
                 mid_size: int):
        super().__init__()
        self.n_down = len(residual_channels)
        for i, (ch, size) in enumerate(zip(residual_channels,
                                           residual_sizes)):
            self.add_module(f"down_blocks_{i}", MMFSBlock(cfg, ch, size))
        self.mid_block = MMFSBlock(cfg, mid_channel, mid_size)

    def blocks(self):
        return [getattr(self, f"down_blocks_{i}")
                for i in range(self.n_down)] + [self.mid_block]

    def project_values(self, mmfs_values: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
        """The ``feat_norm`` + ``value_proj`` of every block, down blocks
        first and mid last."""
        return tuple(b.project_value(mmfs_values) for b in self.blocks())

    def prepare(self, mmfs_values: torch.Tensor, mmfs_mask: torch.Tensor):
        """Every block's image side, for `forward`'s ``prepared``."""
        return tuple(b.prepare(mmfs_values, mmfs_mask) for b in self.blocks())

    def forward(self, sample, down_block_res_samples, prepared: tuple):
        if len(down_block_res_samples) != self.n_down:
            raise ValueError(f"{len(down_block_res_samples)} residuals for "
                             f"{self.n_down} blocks")
        blocks = self.blocks()
        new_res = tuple(res + blk(res, side) for blk, res, side in
                        zip(blocks, down_block_res_samples, prepared))
        sample = sample + blocks[-1](sample, prepared[-1])
        return sample, new_res
