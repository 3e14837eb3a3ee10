"""MMFS's factorised multi-image deformable readout in plain PyTorch: the
delta table of each image, then the gather over every image, level and
point at ``ref + off_q * inv_base`` shifted by the image's delta."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Shapes = Sequence[Tuple[int, int]]


def build_delta(off_img: torch.Tensor, wi: torch.Tensor, level_shapes: Shapes,
                inv_base: float) -> torch.Tensor:
    """Per-image delta table ``[B, H, n_img, L*P*3]`` fp32 of ``(dx, dy,
    wi)`` from the relpos offsets ``off_img [B, n_img, H, P, 2]`` and the
    masked image weight factor ``wi [B, n_img, H, L, P]``."""
    B, n_img, H, P, _ = off_img.shape
    L = len(level_shapes)
    dev = off_img.device
    wl = torch.tensor([float(w) for _, w in level_shapes], device=dev)
    hl = torch.tensor([float(h) for h, _ in level_shapes], device=dev)
    off = off_img.float()
    dx = off[:, :, :, None, :, 0] * inv_base * wl[None, None, None, :, None]
    dy = off[:, :, :, None, :, 1] * inv_base * hl[None, None, None, :, None]
    delta = torch.stack([dx, dy, wi.float()], dim=-1)
    return delta.reshape(B, n_img, H, L * P * 3).transpose(1, 2).contiguous()


def _check_shapes(value, delta, level_shapes, ref, off_q, wq):
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(level_shapes)
    if sum(h * w for h, w in level_shapes) != S:
        raise ValueError(f"spatial shapes {tuple(level_shapes)} != S={S}")
    if B % Bv:
        raise ValueError(f"query batch {B} is not a multiple of the image "
                         f"batch {Bv}")
    want = dict(delta=(Bv, H, n_img, L * P * 3), ref=(B, Lq, 2),
                off_q=(B, Lq, H, P, 2), wq=(B, Lq, H, L, P))
    for name, t in (("delta", delta), ("ref", ref), ("off_q", off_q),
                    ("wq", wq)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} {tuple(t.shape)} != {want[name]}")


def ms_deform_attn_mi_plain(value, delta, level_shapes: Shapes, ref, off_q,
                            wq, inv_base: float) -> torch.Tensor:
    _check_shapes(value, delta, level_shapes, ref, off_q, wq)
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(level_shapes)
    dev = value.device
    bv = torch.arange(B, device=dev) % Bv
    dl = delta.float().reshape(Bv, H, n_img, L, P, 3)[bv]  # [B, H, n, L, P, 3]
    wq32 = wq.float()
    bx = ref[..., 0].float()[:, :, None, None] + off_q[..., 0].float() * inv_base
    by = ref[..., 1].float()[:, :, None, None] + off_q[..., 1].float() * inv_base
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev)
    for n in range(n_img):
        start = 0
        for lid, (hl, wl) in enumerate(level_shapes):
            # [B, H, hw_l, D] for the gather along the texel axis
            val = value[bv, n, start:start + hl * wl].permute(0, 2, 1, 3)
            start += hl * wl
            for p in range(P):
                d = dl[:, :, n, lid, p]  # [B, H, 3]
                x = bx[..., p] * wl - 0.5 + d[:, None, :, 0]  # [B, Lq, H]
                y = by[..., p] * hl - 0.5 + d[:, None, :, 1]
                aw = wq32[:, :, :, lid, p] * d[:, None, :, 2]
                x0 = torch.floor(x)
                y0 = torch.floor(y)
                fx = x - x0
                fy = y - y0
                x0i = x0.long()
                y0i = y0.long()
                s = None
                for dxi, dyi, cw in ((0, 0, (1.0 - fx) * (1.0 - fy)),
                                     (1, 0, fx * (1.0 - fy)),
                                     (0, 1, (1.0 - fx) * fy),
                                     (1, 1, fx * fy)):
                    ix = x0i + dxi
                    iy = y0i + dyi
                    valid = (ix >= 0) & (ix < wl) & (iy >= 0) & (iy < hl)
                    idx = iy.clamp(0, hl - 1) * wl + ix.clamp(0, wl - 1)
                    idx = idx.permute(0, 2, 1)  # [B, H, Lq]
                    g = torch.gather(val, 2,
                                     idx[..., None].expand(B, H, Lq, D))
                    term = (torch.where(valid, cw, torch.zeros_like(cw))[..., None]
                            * g.permute(0, 2, 1, 3).float())
                    s = term if s is None else s + term
                acc = acc + s * aw[..., None]
    return acc.reshape(B, Lq, H * D).to(value.dtype)


def mmfs_deform_factorized(value, delta, level_shapes: Shapes, ref, off_q,
                           wq, inv_base: float) -> torch.Tensor:
    shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    return ms_deform_attn_mi_plain(value, delta, shapes, ref, off_q, wq,
                                   inv_base)
