"""The deformable-attention kernels, forward and backward, and their plain
versions (counterpart of `mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py`).

* `ms_deform_attn_cuda` launches the forward, ``csrc/ms_deform_attn.cu``;
  `ms_deform_attn_bwd_value_cuda` and `ms_deform_attn_bwd_loc_weight_cuda`
  launch the two backward kernels of ``csrc/ms_deform_attn_bwd.cu``.  Each
  runs on PyTorch's current stream, takes CUDA tensors only, raises on
  anything its kernel does not take, and counts its launches in
  ``.launches`` (one call a launch, whatever the kernels inside; a call
  that raises is not counted).  `launch_forward` serves the benchmark's v1
  and v4 forwards, which share one C signature (`ms_deform_attn_v1`,
  `ms_deform_attn_v4`).
* Pure functions of the shapes pick each kernel's body: `forward_variant`
  ("grouped" or "channel"), `value_grad_plan` (where the value gradient's
  binning keeps its cell table, and "grouped" or "lanes") and
  `loc_weight_variant` ("grouped" or "warp").  All three take "grouped"
  where D is 4, 8 or 16 whole 16-byte vectors (a group of lanes a sample
  or a texel, 16-byte loads); there a misaligned input the body loads as
  vectors is refused before any launch.
* `MSDeformAttnFunction` is the differentiable op on the card: its forward
  launches the forward kernel, its backward the two backward kernels.  The
  bare forward wrapper refuses a call that autograd records.
* `ms_deform_attn_plain` is the same function in plain PyTorch: the gather
  path of the JAX package's `_bilinear_gather_one_level`, summed in the same
  order.  The CPU path and the tests use it; `ms_deform_attn_plain_backward`
  differentiates it with autograd.  On the card both are the reference the
  kernels are held against.

All take ``value [N, S, H, D]``, ``loc [N, Q, H, L, P, 2]`` (x, y) in
[0, 1], ``w [N, Q, H, L, P]``; the forward returns ``[N, Q, H*D]`` in the
value's dtype, the backward the gradients in their inputs' dtypes.  Every
kernel sums in a fixed order, so each gives the same bits every run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from .cuda_build import (CountedKernel, forbid_grad, load_library,
                         raise_on_error, stream_of)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ms_deform_attn_plain(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    N, S, H, D = value.shape
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    loc32 = sampling_locations.float()
    w32 = attention_weights.float()
    acc = None
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        value_l = value[:, start:start + h * w].permute(0, 2, 1, 3)  # [N,H,hw,D]
        x = loc32[:, :, :, lid, :, 0] * w - 0.5  # [N, Q, H, P]
        y = loc32[:, :, :, lid, :, 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        lx = x - x0
        ly = y - y0
        x0i = x0.long()
        y0i = y0.long()
        idxs, wgts = [], []
        for dx, dy, cw in (
            (0, 0, (1.0 - lx) * (1.0 - ly)),
            (1, 0, lx * (1.0 - ly)),
            (0, 1, (1.0 - lx) * ly),
            (1, 1, lx * ly),
        ):
            ix = x0i + dx
            iy = y0i + dy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idxs.append(iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
            wgts.append(torch.where(valid, cw, torch.zeros_like(cw)))
        idx = torch.stack(idxs, dim=-1)  # [N, Q, H, P, 4]
        wgt = torch.stack(wgts, dim=-1)
        idx = idx.permute(0, 2, 1, 3, 4).reshape(N, H, Q * P * 4)
        gathered = torch.gather(
            value_l, 2, idx[..., None].expand(N, H, Q * P * 4, D)
        )
        gathered = gathered.view(N, H, Q, P, 4, D).permute(0, 2, 1, 3, 4, 5)
        sampled = (gathered.float() * wgt[..., None]).sum(dim=-2)  # [N,Q,H,P,D]
        contrib = (sampled * w32[:, :, :, lid, :, None]).sum(dim=3)
        acc = contrib if acc is None else acc + contrib
        start += h * w
    return acc.reshape(N, Q, H * D).to(value.dtype)


def ms_deform_attn_plain_backward(value, level_shapes, sampling_locations,
                                  attention_weights, grad_out):
    """``(d_value, d_loc, d_w)`` of `ms_deform_attn_plain` by autograd."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True)
               for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_plain(ins[0], level_shapes, ins[1], ins[2])
        return torch.autograd.grad(out, ins, grad_out)


def _check(name, value, level_shapes, sampling_locations, attention_weights,
           *extra):
    """The shapes, dtypes, devices and layout every kernel of the op takes;
    returns ``(N, S, Q, H, D, L, P)``."""
    tensors = (value, sampling_locations, attention_weights) + extra
    if any(t.device.type != "cuda" or t.device != value.device
           for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: value dtype {value.dtype}")
    loc_dtype = sampling_locations.dtype
    if attention_weights.dtype != loc_dtype or loc_dtype not in (
        value.dtype, torch.float32
    ):
        raise TypeError(
            f"{name}: locations and weights must share a dtype, the value's "
            f"or float32 (got {loc_dtype}, {attention_weights.dtype}, value "
            f"{value.dtype})"
        )
    N, S, H, D = value.shape
    L = len(level_shapes)
    if (sampling_locations.dim() != 6 or sampling_locations.shape[0] != N
            or sampling_locations.shape[2] != H
            or sampling_locations.shape[3] != L
            or sampling_locations.shape[5] != 2):
        raise ValueError(
            f"{name}: locations {tuple(sampling_locations.shape)} do not "
            f"match value {tuple(value.shape)} and {L} levels"
        )
    Q, P = sampling_locations.shape[1], sampling_locations.shape[4]
    if tuple(attention_weights.shape) != (N, Q, H, L, P):
        raise ValueError(
            f"{name}: weights {tuple(attention_weights.shape)} != "
            f"{(N, Q, H, L, P)}"
        )
    for t in extra:  # the output gradient
        if t.shape != (N, Q, H * D) or t.dtype != value.dtype:
            raise ValueError(f"{name}: grad_out {tuple(t.shape)} {t.dtype}, "
                             f"needs {(N, Q, H * D)} {value.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return N, S, Q, H, D, L, P


_functions = {}


def _c_function(library, name, argtypes):
    """``csrc/<library>.cu``'s C entry ``name``, its argument types set once
    (setting them costs microseconds of host time a call)."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(load_library(library), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def _level_array(level_shapes):
    return (ctypes.c_int * (2 * len(level_shapes)))(
        *[s for hw_ in level_shapes for s in hw_])


def launch_forward(name, library, value, level_shapes, sampling_locations,
                   attention_weights, check_dims=None):
    """Launch the forward kernel ``mmi_<library>_fwd`` of
    ``csrc/<library>.cu`` (the C signature of the v1 and v4 forwards);
    ``check_dims(D, P, dtype)`` raises on head and point counts the kernel
    does not take.  Returns ``[N, Q, H*D]`` in the value's dtype."""
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights)
    forbid_grad(name, value, sampling_locations, attention_weights)
    if check_dims is not None:
        check_dims(D, P, value.dtype)
    fn = _c_function(library, f"mmi_{library}_fwd",
                     [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    out = torch.empty((N, Q, H * D), dtype=value.dtype, device=value.device)
    err = fn(
        value.device.index, _DTYPE_CODE[value.dtype],
        _DTYPE_CODE[sampling_locations.dtype],
        value.data_ptr(), sampling_locations.data_ptr(),
        attention_weights.data_ptr(), out.data_ptr(),
        N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value),
    )
    raise_on_error(name, err)
    return out


def _group_lanes(D: int, dtype: torch.dtype) -> int:
    """The lanes a sample (or a texel) takes in the grouped bodies: D's
    16-byte vectors where they are 4, 8 or 16, else 0 (``group_lanes`` of
    ``csrc/ms_deform_attn_common.cuh``)."""
    nbytes = D * (torch.finfo(dtype).bits // 8)
    g = nbytes // 16
    return g if nbytes % 16 == 0 and g in (4, 8, 16) else 0


def forward_variant(D: int, dtype: torch.dtype) -> str:
    """The forward's body for a head width ``D`` of values in ``dtype``:
    "grouped" where D is 4, 8 or 16 whole 16-byte vectors (a group of that
    many lanes takes a sample), else "channel" (a thread a channel, any
    D)."""
    return "grouped" if _group_lanes(D, dtype) else "channel"


# the dynamic shared memory a block of the value gradient's binning may take
# on the H100 (227 KB, less 1 KB for its static tables)
SHARED_BYTES = 232448 - 1024


class ValueGradPlan(NamedTuple):
    """How the value gradient runs a call.  ``cells``: the bins of an
    (n, h)'s samples, (h + 1) * (w + 1) a level.  The binning takes one CTA
    per (n, h, level) of ``bin_warps`` warps, each warp a contiguous run of
    the level's samples and a row of the level's cell table: ``table``
    "shared" (the [bin_warps + 1, cells_l] table in shared memory) or
    "global" (in a device scratch, where no 4 warps' rows fit).  ``body``:
    "grouped" (G lanes a sample, 16-byte loads of dOut) or "lanes" (lanes
    along D, any D).  ``walks``, per level: "group" (a group of G lanes a
    texel, where the walk of a texel's four cells is 32 samples or fewer on
    average) or "warp" (a warp a texel)."""
    cells: int
    table: str
    bin_warps: int
    body: str
    walks: Tuple[str, ...]


def value_grad_plan(level_shapes: Sequence[Tuple[int, int]], Q: int, L: int,
                    P: int, D: int, dtype: torch.dtype) -> ValueGradPlan:
    """The value gradient's plan for a call (a pure function of the
    shapes); raises where an (n, h)'s Q*L*P sample ids do not fit in
    int32."""
    if len(level_shapes) != L:
        raise ValueError(f"{L} levels, level_shapes {level_shapes}")
    if Q * L * P > 2 ** 31 - 1:
        raise ValueError(f"value gradient: Q*L*P = {Q * L * P} sample ids "
                         "of an (n, h) do not fit in int32")
    per_level = [(h + 1) * (w + 1) for h, w in level_shapes]
    fit = SHARED_BYTES // (4 * max(per_level)) - 1
    table, warps = ("shared", min(32, fit)) if fit >= 4 else ("global", 8)
    if not _group_lanes(D, dtype):
        return ValueGradPlan(sum(per_level), table, warps, "lanes",
                             ("warp",) * L)
    walks = tuple("group" if Q * P <= 8 * c else "warp" for c in per_level)
    return ValueGradPlan(sum(per_level), table, warps, "grouped", walks)


def _refuse_misaligned(name, t, what, D, dtype):
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary "
                         f"at D = {D} ({dtype})")


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the forward kernel; raises on input it does not take.  The
    "grouped" body loads 16-byte vectors of the value: there a value off a
    16-byte boundary is refused before any launch."""
    name = "ms_deform_attn_cuda"
    variant = (forward_variant(value.shape[-1], value.dtype)
               if value.dtype in _DTYPE_CODE else "channel")
    if variant == "grouped":
        _refuse_misaligned(name, value, "value", value.shape[-1], value.dtype)
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights)
    forbid_grad(name, value, sampling_locations, attention_weights)
    fn = _c_function("ms_deform_attn", "mmi_ms_deform_attn_fwd",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    out = torch.empty((N, Q, H * D), dtype=value.dtype, device=value.device)
    err = fn(value.device.index, _DTYPE_CODE[value.dtype],
             _DTYPE_CODE[sampling_locations.dtype], int(variant == "grouped"),
             value.data_ptr(), sampling_locations.data_ptr(),
             attention_weights.data_ptr(), out.data_ptr(),
             N, S, Q, H, D, L, P, _level_array(level_shapes),
             stream_of(value))
    raise_on_error(name, err)
    return out


def _launch_bwd_value(value, level_shapes, sampling_locations,
                      attention_weights, grad_out):
    """Launch the value gradient (the samples' cells, their stable binning,
    then the gather: three kernels, no float atomics); returns ``[N, S, H,
    D]`` in the value's dtype.  The
    "grouped" body loads 16-byte vectors of dOut: there a grad_out off a
    16-byte boundary is refused before any launch, as are locations off a
    boundary of two elements (both bodies load an (x, y) pair at once)."""
    name = "ms_deform_attn_bwd_value"
    if (value.dtype in _DTYPE_CODE
            and _group_lanes(value.shape[-1], value.dtype)):
        _refuse_misaligned(name, grad_out, "grad_out", value.shape[-1],
                           value.dtype)
    if sampling_locations.data_ptr() % (2 * sampling_locations.element_size()):
        raise ValueError(f"{name}: sampling_locations must start on a "
                         "boundary of two elements (one (x, y) pair a load)")
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    plan = value_grad_plan(level_shapes, Q, L, P, D, value.dtype)
    fn = _c_function("ms_deform_attn_bwd", "mmi_ms_deform_attn_bwd_value",
                     [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    dev = value.device
    keys = torch.empty((N * H, L, Q * P), dtype=torch.int32, device=dev)
    ids = torch.empty((N * H, Q * L * P), dtype=torch.int32, device=dev)
    cell_start = torch.empty((N * H, plan.cells + L), dtype=torch.int32,
                             device=dev)
    table = (torch.empty((N * H, plan.bin_warps + 1, plan.cells),
                         dtype=torch.int32, device=dev)
             if plan.table == "global" else None)
    grad = torch.empty((N, S, H, D), dtype=value.dtype, device=dev)
    group_levels = sum(1 << l for l, w in enumerate(plan.walks)
                       if w == "group")
    err = fn(dev.index, _DTYPE_CODE[value.dtype],
             _DTYPE_CODE[sampling_locations.dtype], plan.bin_warps,
             int(plan.table == "shared"), int(plan.body == "grouped"),
             group_levels, sampling_locations.data_ptr(),
             attention_weights.data_ptr(), grad_out.data_ptr(),
             keys.data_ptr(), ids.data_ptr(), cell_start.data_ptr(),
             None if table is None else table.data_ptr(), grad.data_ptr(),
             N, S, Q, H, D, L, P, _level_array(level_shapes),
             stream_of(value))
    raise_on_error(name, err)
    return grad


def loc_weight_variant(D: int, dtype: torch.dtype) -> str:
    """The location/weight-gradient body for a head width ``D`` of values in
    ``dtype``: "grouped" where D is 4, 8 or 16 whole 16-byte vectors (a
    group of that many lanes takes a sample), else "warp" (a warp a sample,
    any D)."""
    return "grouped" if _group_lanes(D, dtype) else "warp"


def _launch_bwd_loc_weight(value, level_shapes, sampling_locations,
                           attention_weights, grad_out):
    """Launch the location/weight-gradient kernel; returns ``(d_loc, d_w)``
    in the dtype of the locations and weights.  The "grouped" body loads
    16-byte vectors of the value and dOut: there a base off a 16-byte
    boundary is refused before any launch."""
    name = "ms_deform_attn_bwd_loc_weight"
    variant = (loc_weight_variant(value.shape[-1], value.dtype)
               if value.dtype in _DTYPE_CODE else "warp")
    if variant == "grouped":
        for what, t in (("value", value), ("grad_out", grad_out)):
            _refuse_misaligned(name, t, what, value.shape[-1], value.dtype)
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    fn = _c_function("ms_deform_attn_bwd",
                     "mmi_ms_deform_attn_bwd_loc_weight",
                     [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
                     + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    dev = value.device
    dt = sampling_locations.dtype
    d_loc = torch.empty((N, Q, H, L, P, 2), dtype=dt, device=dev)
    d_w = torch.empty((N, Q, H, L, P), dtype=dt, device=dev)
    err = fn(dev.index, _DTYPE_CODE[value.dtype], _DTYPE_CODE[dt],
             int(variant == "grouped"), value.data_ptr(),
             sampling_locations.data_ptr(), attention_weights.data_ptr(),
             grad_out.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
             N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value))
    raise_on_error(name, err)
    return d_loc, d_w


ms_deform_attn_cuda = CountedKernel(_launch)
ms_deform_attn_bwd_value_cuda = CountedKernel(_launch_bwd_value)
ms_deform_attn_bwd_loc_weight_cuda = CountedKernel(_launch_bwd_loc_weight)


class MSDeformAttnFunction(torch.autograd.Function):
    """The deformable op on the card: the forward kernel, and the two
    backward kernels for whichever gradients autograd asks for."""

    @staticmethod
    def forward(ctx, value, level_shapes, sampling_locations,
                attention_weights):
        ctx.level_shapes = level_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, level_shapes, sampling_locations,
                                   attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, w = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        d_value = d_loc = d_w = None
        if ctx.needs_input_grad[0]:
            d_value = ms_deform_attn_bwd_value_cuda(value, ctx.level_shapes,
                                                    loc, w, grad_out)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            d_loc, d_w = ms_deform_attn_bwd_loc_weight_cuda(
                value, ctx.level_shapes, loc, w, grad_out)
        return d_value, None, d_loc, d_w
