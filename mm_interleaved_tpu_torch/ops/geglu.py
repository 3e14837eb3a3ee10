"""The fused GEGLU feed-forward kernel and its plain version (counterpart
of `mm_interleaved_tpu/ops/geglu.py`).

``(a * gelu_erf(g)) @ w2^T + b2`` with ``[a | g] = x @ w1^T + b1`` — the
UNet TransformerBlock's feed-forward — for ``x [..., C]`` and PyTorch
Linear weights ``w1 [8C, C]`` (the halves in diffusers order), ``w2 [C,
4C]``.  As in the TPU kernel, a and g stay fp32 and their product is
rounded to x's dtype before the second product.

* `geglu_cuda` launches ``csrc/geglu.cu`` (``.launches`` counts its
  launches) for ``C <= 640``; it raises on anything else.  Which of the
  kernel's variants runs is `geglu_variant`'s choice by shape and dtype:
  the Hopper kernel (wgmma, TMA) for bf16 at the flagship's widths, the
  CUDA-core body elsewhere.  The Hopper kernel loads x, w1 and w2 by TMA:
  at its widths a base off 16 bytes raises.
* `geglu_plain` is the same function in plain PyTorch; the CPU path uses
  it, and on the card it is the reference the kernel is held against.

`geglu_mlp` dispatches by device.  `geglu_fused_eligible` is the UNet
block's rule: the fused kernel serves calls of width C <= 640 that autograd
does not record (the JAX gate serves inference traces alone); the C = 1280
blocks and every training call stay two matmuls and a plain GEGLU, as XLA
computes them in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, needs_grad, raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 640
# the kernel's variants, by the code its C interface takes
# (in the order of preference)
VARIANTS = {"wgmma_rows": 1, "wgmma_cols": 2, "cuda_core": 0}


def geglu_accepts(variant: str, C: int, Fh: int, dtype: torch.dtype) -> bool:
    """Whether ``variant`` of ``csrc/geglu.cu`` takes width ``C``, hidden
    width ``Fh`` and ``dtype``: the Hopper kernel's "wgmma_rows" (128
    tokens a CTA, each consumer warpgroup 64 rows of all C columns) ``C =
    64 .. 320`` and "wgmma_cols" (64 tokens, the C columns split between
    the two consumers) ``C = 384, 512, 640``, both in bf16 with ``Fh % 64
    == 0``; "cuda_core" anything up to `MAX_WIDTH`."""
    if variant not in VARIANTS:
        raise ValueError(f"geglu: unknown variant {variant!r}")
    if C > MAX_WIDTH:
        return False
    if variant == "cuda_core":
        return True
    if dtype != torch.bfloat16 or Fh % 64 or C % 64:
        return False
    if variant == "wgmma_rows":
        return C <= 320
    return C % 128 == 0 and C >= 384  # wgmma_cols


def geglu_variant(C: int, Fh: int, dtype: torch.dtype) -> str:
    """The variant that serves a call: the first of "wgmma_rows",
    "wgmma_cols", "cuda_core" that `geglu_accepts` it (a choice by shape,
    not a fallback: a variant never retries as another)."""
    return next(v for v in VARIANTS if geglu_accepts(v, C, Fh, dtype))


def geglu_fused_eligible(C: int, *tensors: torch.Tensor) -> bool:
    """Width ``C`` fits the kernel and autograd records no call on
    ``tensors`` (the input and the weights)."""
    return C <= MAX_WIDTH and not needs_grad(*tensors)


def geglu_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    Fh = w2.shape[1]
    h = x.float() @ w1.float().t() + b1.float()
    g = (h[..., :Fh] * F.gelu(h[..., Fh:])).to(x.dtype)
    return (g.float() @ w2.float().t() + b2.float()).to(x.dtype)


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    """Launch the CUDA kernel as `geglu_variant` picks; raises on input it
    does not take."""
    name = "geglu"
    C = x.shape[-1]
    Fh = w2.shape[1]
    if any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise TypeError(f"{name}: weights must share x's dtype {x.dtype}")
    if (w1.shape != (2 * Fh, C) or b1.shape != (2 * Fh,)
            or w2.shape != (C, Fh) or b2.shape != (C,)):
        raise ValueError(f"{name}: w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)},"
                         f" w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} for "
                         f"C={C}")
    if C > MAX_WIDTH:
        raise ValueError(f"{name}: width {C} > {MAX_WIDTH}")
    variant = geglu_variant(C, Fh, x.dtype)
    # TMA loads need 16-byte aligned bases; torch.empty_like keeps x's
    # alignment for the output (the allocator's blocks are 512-byte aligned)
    if variant != "cuda_core" and any(t.data_ptr() % 16
                                      for t in (x, w1, w2)):
        raise ValueError(f"{name}: {variant} needs x, w1 and w2 on 16-byte "
                         "boundaries (a misaligned view: pass a copy)")
    check_cuda(name, (x, w1, b1, w2, b2))
    forbid_grad(name, x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    fn = load_library("geglu").mmi_geglu_fwd
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.device.index, _DTYPE_CODE[x.dtype], VARIANTS[variant],
             x.data_ptr(),
             w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
             out.data_ptr(), x.numel() // C, C, Fh, stream_of(x))
    raise_on_error(f"{name} ({variant})", err)
    return out


geglu_cuda = CountedKernel(_launch)


def geglu_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """The fused feed-forward: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if x.device.type == "cuda":
        return geglu_cuda(x.contiguous(), w1, b1, w2, b2)
    return geglu_plain(x, w1, b1, w2, b2)
