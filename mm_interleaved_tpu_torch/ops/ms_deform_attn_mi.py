"""The factorised multi-image deformable-attention kernel (the UNet's MMFS
readout) and its plain version (counterpart of
`mm_interleaved_tpu/ops/ms_deform_attn_pallas_mi.py`, forward only).

Locations and weights split into a query part and a per-image part,

    x = (ref_x + off_x * inv_base) * W_l - 0.5 + dx[b, h, n, l, p]
    w = wq[b, q, h, l, p] * wi[b, h, n, l, p]

(and the same for y), so the wide per-(query, image) tensors are never
built.  The image side — ``value [Bv, n_img, hw, H, D]`` and the delta
table of `build_delta` — may carry a smaller batch than the queries: query
row ``c * Bv + b`` reads image row ``b`` (one image side shared by the CFG
halves).  Sampling is bilinear with zero padding (``align_corners=False``)
and accumulates in fp32.  The TPU's value slabs, occupancy bit-words and
query slab have no counterpart: the kernel gathers from ``value`` as it is.

* `ms_deform_attn_mi_cuda` launches ``csrc/ms_deform_attn_mi.cu``
  (``.launches`` counts its launches), as the variant `mi_variant` picks:
  "tiled" (a CTA per image row, head and tile of neighbouring queries of
  both CFG halves, in `query_tile_order`) where a texel row is a whole
  number of 16-byte lanes, "flat" elsewhere.  The tiled kernel's 16-byte
  loads need ``value`` on a 16-byte boundary: a base off it raises;
* `ms_deform_attn_mi_plain` is the same function in plain PyTorch, summed
  in the kernel's order (images, levels, points, then the four corners);
* `mmfs_deform_factorized` dispatches by device: every CUDA call launches
  the kernel, a CPU call takes the plain version.

All take ``value``, ``delta [Bv, H, n_img, L*P*3]`` fp32, ``ref [B, Lq,
2]`` fp32, ``off_q [B, Lq, H, P, 2]`` fp32 and ``wq [B, Lq, H, L, P]`` in
the value dtype, and return ``[B, Lq, H*D]`` in the value dtype.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's variants, by the code its C interface takes
VARIANTS = {"tiled": 1, "flat": 0}  # in the order of preference
TILE = 8  # the side of a square tile of queries
MAX_LEVELS = 8  # csrc: kMaxLevels

Shapes = Sequence[Tuple[int, int]]


def mi_accepts(variant: str, D: int, dtype: torch.dtype) -> bool:
    """Whether ``variant`` of ``csrc/ms_deform_attn_mi.cu`` takes head
    width ``D`` in ``dtype``: "tiled" where a texel row is 1, 2, 4, 8, 16
    or 32 whole 16-byte lanes (D % 8 == 0 up to 256 in bf16, D % 4 == 0 up
    to 128 in fp32); "flat" always."""
    if variant not in VARIANTS:
        raise ValueError(f"ms_deform_attn_mi: unknown variant {variant!r}")
    if variant == "flat":
        return True
    row = D * torch.empty((), dtype=dtype).element_size()
    return row % 16 == 0 and row // 16 in (1, 2, 4, 8, 16, 32)


def mi_variant(D: int, dtype: torch.dtype) -> str:
    """The variant that serves a call: "tiled" where `mi_accepts` it, else
    "flat" (a choice by shape; a variant never retries as another)."""
    return next(v for v in VARIANTS if mi_accepts(v, D, dtype))


def query_tile_order(Lq: int) -> torch.Tensor:
    """The order in which the tiled kernel takes the queries, ``[Lq]``
    int64: for a square grid whose side W is a multiple of `TILE` (the
    UNet's row-major 64, 32, 16 and 8 px maps), `TILE` x `TILE` blocks in
    row-major block order, each block row-major; otherwise the identity.
    A CTA takes a run of consecutive entries (64 at the flagship)."""
    W = int(round(Lq ** 0.5))
    if W * W != Lq or W % TILE or W == TILE:
        return torch.arange(Lq)
    n = W // TILE
    grid = torch.arange(Lq).reshape(n, TILE, n, TILE)  # [by, i, bx, j]
    return grid.permute(0, 2, 1, 3).reshape(Lq)


_orders = {}


def _order_on(Lq: int, device) -> torch.Tensor:
    key = (Lq, str(device))
    if key not in _orders:
        _orders[key] = query_tile_order(Lq).to(device=device,
                                               dtype=torch.int32)
    return _orders[key]


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


def _launch(value, delta, level_shapes: Shapes, ref, off_q, wq,
            inv_base: float) -> torch.Tensor:
    """Launch the CUDA kernel as `mi_variant` picks; raises on input it
    does not take."""
    name = "ms_deform_attn_mi"
    if wq.dtype != value.dtype:
        raise TypeError(f"{name}: wq dtype {wq.dtype} != value {value.dtype}")
    _check_shapes(value, delta, level_shapes, ref, off_q, wq)
    Bv, n_img, S, H, D = value.shape
    B, Lq, _, P, _ = off_q.shape
    L = len(level_shapes)
    if L > MAX_LEVELS:
        raise ValueError(f"{name}: {L} levels > {MAX_LEVELS}")
    variant = mi_variant(D, value.dtype)
    # the output, from torch.empty, is aligned as the allocator's blocks
    if variant == "tiled" and value.data_ptr() % 16:
        raise ValueError(f"{name}: the tiled kernel needs value on a 16-byte "
                         "boundary (a misaligned view: pass a copy)")
    check_cuda(name, (value, wq))
    check_cuda(name, (delta, ref, off_q, value), dtypes=(torch.float32,))
    forbid_grad(name, value, delta, ref, off_q, wq)
    fn = load_library("ms_deform_attn_mi").mmi_ms_deform_attn_mi_fwd
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7 \
        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p,
                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, Lq, H * D), dtype=value.dtype, device=value.device)
    order = _order_on(Lq, value.device) if variant == "tiled" else None
    hw = (ctypes.c_int * (2 * L))(*[s for hw_ in level_shapes for s in hw_])
    err = fn(value.device.index, _DTYPE_CODE[value.dtype], VARIANTS[variant],
             value.data_ptr(), delta.data_ptr(), ref.data_ptr(),
             off_q.data_ptr(), wq.data_ptr(), out.data_ptr(),
             None if order is None else order.data_ptr(), Bv, B, Lq, n_img,
             S, H, D, L, P, float(inv_base), hw, stream_of(value))
    raise_on_error(f"{name} ({variant})", err)
    return out


ms_deform_attn_mi_cuda = CountedKernel(_launch)


def mmfs_deform_factorized(value, delta, level_shapes: Shapes, ref, off_q,
                           wq, inv_base: float) -> torch.Tensor:
    """The factorised readout: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one."""
    shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    if value.device.type == "cuda":
        return ms_deform_attn_mi_cuda(
            value.contiguous(), delta.contiguous(), shapes,
            ref.float().contiguous(), off_q.float().contiguous(),
            wq.contiguous(), inv_base)
    return ms_deform_attn_mi_plain(value, delta, shapes, ref, off_q, wq,
                                   inv_base)
