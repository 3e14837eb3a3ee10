"""Weight-only int8 quantization of the LLM, its CUDA kernel and its plain
version (counterpart of `mm_interleaved_tpu/ops/quant.py`).

Symmetric absmax per output channel over the reduction axis, computed in
fp32 and clipped to +-127, once before generation; activations keep their
dtype.  The port's Linear weight is ``[out, in]``, so the reduction runs
over ``in`` and the scale is fp32 ``[out]`` (the JAX kernel is ``[in,
out]`` with the scale over axis -2: the same numbers, transposed).

* `QLinear` is the counterpart of `QDense`: an int8 ``weight``, an fp32
  ``scale`` and the optional ``bias``, parameters without gradient.  Its
  forward is ``y = x @ (q * s)^T + b`` with the dequantized weight
  ``q.to(dtype) * s.to(dtype)`` as JAX rounds it (``dequantize_int8``),
  then ``+ b`` in the dtype, as `QDense` adds it.
* `int8_linear_cuda` launches ``csrc/int8_linear.cu`` (``.launches``
  counts its launches): the JAX package gets the dequantization fused into
  the dot's operand read from XLA (`QDense`, :85-97); the port gets it from
  this kernel, which reads the codes once and never writes a dequantized
  copy.  Its body is `int8_linear_body`'s choice by M, N, K and dtype;
  the wgmma body's tiles and K splits are `int8_linear_plan`'s (pure, so
  the CPU tests check them).
  `int8_linear_plain` is the same function in plain PyTorch (a
  dequantized copy, then a matmul); the CPU path uses it, and on the card
  it is the reference the kernel is held against.  `int8_linear`
  dispatches by device.
* `quantize_llm_weights(model)` replaces, in place and one layer at a time,
  exactly the Linear layers JAX's `_is_quant_path` selects: the
  ``q/k/v/o_proj`` and ``gate/up/down_proj`` under ``mm_decoder`` (or the
  ``layers`` of a bare `LlamaModel`) and ``head`` / ``head_new`` under
  ``text_decoder``; never the MMFS projections, the ViT, the Q-Former or
  the UNet.  Quantize after the model has its dtype: ``model.to(dtype)``
  would cast the fp32 scales too.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
from torch import nn

from .cuda_build import (CountedKernel, check_cuda, forbid_grad,
                         load_library, raise_on_error, stream_of)

# the Linear layers eligible for weight-only quantization (JAX's
# `_LLM_PROJ_NAMES`) and the roots they must sit under (`_LLM_ROOTS`)
LLM_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
                  "gate_proj", "up_proj", "down_proj", "head", "head_new")
LLM_ROOTS = ("mm_decoder", "text_decoder", "layers")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's bodies, by the code its C interface takes
BODIES = {"gemv": 0, "mma": 1, "simt": 2, "wgmma": 3}
# the most rows the GEMV body takes (fp32, and bf16 with K % 16 != 0; the
# decodes: B = 2 greedy, K = 5 beams x B = 2, the bench's B = 8)
GEMV_MAX_M = 16
# the wgmma body's tiles: 128 weight rows (outputs) a CTA, x rows a tile
# one of WGMMA_BN (wgmma's n; 176 puts M = 512 in three tiles), K in
# stages of `wgmma_k`, K splits one of WGMMA_SPLITS (a cluster of a power
# of two CTAs: clusters of 3 or 6 left SMs idle on the H100)
WGMMA_ROWS = 128
WGMMA_BN = (8, 16, 32, 64, 128, 176, 256)
WGMMA_SPLITS = (1, 2, 4, 8)


def wgmma_k(bn: int) -> int:
    """K a stage of the wgmma body at ``bn`` x rows a tile: 128 (code rows
    of 128 bytes), 64 at 256 (whose x tiles leave room for two stages of
    128 only); as ``wg_k`` in the kernel."""
    return 64 if bn >= 256 else 128


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 over the reduction axis (the last: ``w`` is
    ``[..., out, in]``) -> ``(int8 [..., out, in], fp32 [..., out])``."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``q.to(dtype) * scale.to(dtype)`` per output row (JAX's
    ``dequantize_int8``)."""
    return q.to(dtype) * scale.to(dtype)[..., None]


def int8_linear_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ dequantize_int8(q, scale, x.dtype)^T``, then ``+ bias`` in
    x's dtype (`QDense`'s two roundings)."""
    y = torch.matmul(x, dequantize_int8(q, scale, x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def int8_linear_vec(K: int) -> bool:
    """Whether a call of reduction width ``K`` takes the 16-byte vector
    loads (then x, the codes and the output must sit on 16-byte
    boundaries); otherwise every load is a guarded scalar."""
    return K % 16 == 0


def int8_linear_body(M: int, N: int, K: int, dtype: torch.dtype) -> str:
    """The kernel body that serves ``x [M, K]`` times ``q [N, K]`` in
    ``dtype``: bf16 with K % 16 == 0 (every LLM projection) "wgmma" (TMA,
    wgmma, split-K over a cluster: `int8_linear_plan`), which measured
    faster than the GEMV and mma.sync bodies at every flagship site on the
    H100, decode (M = 2-10) and prefill alike (PERF.md, PR 16); bf16 with
    K % 16 != 0 "gemv" at M <= `GEMV_MAX_M`, else "mma" (mma.sync); fp32
    "gemv" at M <= `GEMV_MAX_M`, else "simt" (fp32 on the CUDA cores)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"int8_linear: dtype {dtype} not in "
                        f"{tuple(_DTYPE_CODE)}")
    if dtype == torch.bfloat16 and int8_linear_vec(K):
        return "wgmma"
    if M <= GEMV_MAX_M:
        return "gemv"
    return "mma" if dtype == torch.bfloat16 else "simt"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_cost(M: int, N: int, K: int, bn: int, split: int,
               sms: int) -> float:
    """The wgmma body's time in microseconds, as a model fitted to a sweep
    of every (bn, split) at the flagship's sites on an H100 (PERF.md, PR
    16): waves of CTAs, each paying about 4 us to start and stop, for each
    64 of its K the larger of its own pipeline's pace (0.28 + 0.0018 bn
    us) and its codes' share of HBM (3.35 TB/s over the CTAs in flight),
    and with a split the partials' meeting (1 + 0.004 bn (split - 1) us).
    A cluster of ``split`` CTAs sits in one GPC: at most ``15 // split``
    clusters in each of 8."""
    ks = wgmma_k(bn)
    ctas = _cdiv(M, bn) * _cdiv(N, WGMMA_ROWS) * split
    cap = sms if split == 1 else min(sms, 8 * (15 // split) * split)
    active = min(ctas, cap)
    per64 = max(0.28 + 0.0018 * bn,
                64 * min(N, WGMMA_ROWS) * active / 3.35e6)
    meet = 1.0 + 0.004 * bn * (split - 1) if split > 1 else 0.0
    cta = 4.0 + _cdiv(_cdiv(K, ks), split) * (ks // 64) * per64 + meet
    return _cdiv(ctas, cap) * cta


@functools.lru_cache(maxsize=4096)
def int8_linear_plan(M: int, N: int, K: int, sms: int = 132) -> dict:
    """The wgmma body's plan for ``x [M, K]`` times ``q [N, K]`` on a card
    of ``sms`` multiprocessors (pure: no card is asked).  A CTA owns
    ``WGMMA_ROWS`` weight rows by ``bn`` rows of x; ``split`` CTAs of one
    cluster share the tile's T K tiles of ``k_tile`` (`wgmma_k`): split j
    takes tiles ``[j T // split, (j + 1) T // split)``, so none is empty,
    and they meet in the cluster's shared memory in split order.  The pair
    (bn, split) is the one `_plan_cost` rates fastest (ties to fewer
    splits, then fewer rows a tile).  ``k_splits``: each split's [k0, k1)
    in elements."""
    if min(M, N, K, sms) < 1:
        raise ValueError(f"int8_linear_plan: M={M} N={N} K={K} sms={sms}")
    best = None
    for bn in WGMMA_BN:
        kt = _cdiv(K, wgmma_k(bn))
        for split in (sp for sp in WGMMA_SPLITS if sp <= kt):
            key = (_plan_cost(M, N, K, bn, split, sms), split, bn)
            if best is None or key < best:
                best = key
    split, bn = best[1], best[2]
    ks = wgmma_k(bn)
    kt = _cdiv(K, ks)
    bounds = [j * kt // split for j in range(split + 1)]
    return dict(bn=bn, split=split, m_tiles=_cdiv(M, bn),
                n_tiles=_cdiv(N, WGMMA_ROWS), k_tile=ks, k_tiles=kt,
                k_splits=tuple((bounds[j] * ks, min(bounds[j + 1] * ks, K))
                               for j in range(split)))


_ENTRY = []
_SMS = {}


def _entry():
    """The C entry point, its argument types set once (a decode step calls
    it 282 times at the flagship: the host's cost a call matters)."""
    if not _ENTRY:
        fn = load_library("int8_linear").mmi_int8_linear
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _sms(device: torch.device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _check(x, q, scale, bias) -> str:
    """Raise, before any launch, on input the kernel does not take; else
    return the body that serves it."""
    name = "int8_linear"
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, q {tuple(q.shape)}: "
                         "want [M, K] and [N, K]")
    M, K = x.shape
    N = q.shape[0]
    if M < 1 or N < 1 or K < 1:
        raise ValueError(f"{name}: empty product M={M} N={N} K={K}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (N,):
        raise TypeError(f"{name}: q must be int8 [N, K], scale fp32 [N]; got "
                        f"{q.dtype} {tuple(q.shape)}, {scale.dtype} "
                        f"{tuple(scale.shape)}")
    if bias is not None and (bias.dtype != x.dtype or bias.shape != (N,)):
        raise TypeError(f"{name}: bias must be {x.dtype} [N]")
    body = int8_linear_body(M, N, K, x.dtype)
    tensors = [x, q, scale] + ([bias] if bias is not None else [])
    check_cuda(name, tensors)
    forbid_grad(name, *tensors)
    if int8_linear_vec(K) and any(t.data_ptr() % 16 for t in (x, q)):
        raise ValueError(f"{name}: K % 16 == 0 takes 16-byte loads: x and q "
                         "must sit on 16-byte boundaries (a misaligned view: "
                         "pass a copy)")
    return body


def _run(x, q, scale, bias, body: str, plan) -> torch.Tensor:
    """One launch of ``body`` (with the wgmma body's ``plan``) on inputs
    `_check` passed."""
    M, K = x.shape
    N = q.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    bn, split = (plan["bn"], plan["split"]) if plan is not None else (0, 0)
    err = _entry()(x.device.index, _DTYPE_CODE[x.dtype], BODIES[body],
                   int(int8_linear_vec(K)), x.data_ptr(), q.data_ptr(),
                   scale.data_ptr(),
                   None if bias is None else bias.data_ptr(), out.data_ptr(),
                   M, N, K, bn, split, stream_of(x))
    raise_on_error(f"int8_linear ({body})", err)
    return out


def _launch(x, q, scale, bias=None) -> torch.Tensor:
    """Launch the CUDA kernel on ``x [M, K]``, ``q [N, K]`` int8, ``scale
    [N]`` fp32 and ``bias [N]`` (x's dtype) or None, with the body
    `int8_linear_body` and, for "wgmma", the plan `int8_linear_plan`
    give; raises, before any launch, on input it does not take."""
    body = _check(x, q, scale, bias)
    M, K = x.shape
    plan = (int8_linear_plan(M, q.shape[0], K, _sms(x.device))
            if body == "wgmma" else None)
    return _run(x, q, scale, bias, body, plan)


int8_linear_cuda = CountedKernel(_launch)


def int8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x [..., K]`` through the int8 linear layer: the CUDA kernel on a
    CUDA tensor (x's rows flattened, copied first where they are not
    contiguous or, for the vector loads, not on a 16-byte boundary), the
    plain version on a CPU one."""
    if x.device.type != "cuda":
        return int8_linear_plain(x, q, scale, bias)
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if not x2.is_contiguous() or (int8_linear_vec(K)
                                  and x2.data_ptr() % 16):
        x2 = x2.clone(memory_format=torch.contiguous_format)
    out = int8_linear_cuda(x2, q, scale, bias)
    return out.view(*x.shape[:-1], q.shape[0])


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class QLinear(nn.Module):
    """A Linear layer with int8 weights: ``weight`` int8 ``[out, in]`` and
    ``scale`` fp32 ``[out]``, ``bias`` as the Linear's, all three
    parameters that need no gradient (FSDP2 shards parameters; a buffer it
    would keep whole on every rank)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = _frozen(torch.zeros(
            (out_features, in_features), dtype=torch.int8, device=device))
        self.scale = _frozen(torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (_frozen(torch.zeros(out_features, dtype=dtype,
                                         device=device)) if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QLinear":
        w = linear.weight.data
        out = cls(linear.in_features, linear.out_features,
                  bias=linear.bias is not None, device=w.device,
                  dtype=w.dtype)
        q, scale = quantize_int8(w)
        out.weight, out.scale = _frozen(q), _frozen(scale)
        if linear.bias is not None:
            out.bias.data.copy_(linear.bias.data)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.weight, self.scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}, int8")


def is_quant_name(name: str) -> bool:
    """Whether the module ``name`` (dotted, from ``named_modules``) is one
    `quantize_llm_weights` replaces: a projection of `LLM_PROJ_NAMES`
    under a root of `LLM_ROOTS` (JAX's `_is_quant_path`)."""
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] in LLM_PROJ_NAMES
            and parts[0] in LLM_ROOTS)


def quantize_llm_weights(model: nn.Module) -> List[str]:
    """Replace the LLM's projection layers (`is_quant_name`) by `QLinear`s
    in place, one layer at a time, so the peak holds one layer's two
    copies at most; returns the replaced names.  A model that holds a
    `QLinear` already raises (JAX asserts the same: codes must not be
    quantized again)."""
    names = [n for n, m in model.named_modules() if is_quant_name(n)]
    for n in names:
        if isinstance(model.get_submodule(n), QLinear):
            raise ValueError(f"already quantized: {n}")
    for n in names:
        parent, _, child = n.rpartition(".")
        owner = model.get_submodule(parent)
        linear = getattr(owner, child)
        if not isinstance(linear, nn.Linear):
            raise TypeError(f"{n}: {type(linear).__name__} is not a Linear")
        setattr(owner, child, QLinear.from_linear(linear))
        del linear
    return names
