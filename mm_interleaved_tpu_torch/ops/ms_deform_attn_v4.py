"""Deformable attention as the dense bilinear-matrix product, the v4
formulation (counterpart of `mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py`),
forward and backward.

Per (batch, head) and level ``l`` the formulation builds the matrix

    A[q, y*w + x] = sum_p  aw_p[q] * hat(x - xs_p[q]) * hat(y - ys_p[q]),

``hat(t) = relu(1 - |t|)`` over the level's row-major texels, rounds A to
the value's dtype and takes ``A @ V_l`` with fp32 accumulation; the levels'
products are summed in order.  ``xs = loc_x * w - 0.5`` (``align_corners=
False``); a texel outside the grid does not exist, so out-of-grid corners
contribute zero, as in `ms_deform_attn`.

The backward is the TPU kernels' (the docstring of the JAX module), with
dOut ``g`` rounded to the value's dtype and every sum in fp32:

    dV_l   = A_l^T g                     (A rounded to the value's dtype)
    dA_l   = g V_l^T
    d_aw_p = sum_f wx wy dA,   d_xs_p = aw_p sum_f sx wy dA,
    d_ys_p = aw_p sum_f wx sy dA,

``wx = hat(x - xs_p)``, ``sx = sign(x - xs_p)`` where ``|x - xs_p| < 1``
and 0 elsewhere (so 0 at ``|x - xs_p| = 1`` and at ``x = xs_p``), and the
same in y; then ``d loc_x = d_xs * w`` and ``d loc_y = d_ys * h``.

* `ms_deform_attn_v4_plain`, `ms_deform_attn_v4_plain_bwd_value`,
  `ms_deform_attn_v4_plain_bwd_loc_weight` (and
  `ms_deform_attn_v4_plain_backward`, both): that arithmetic in plain
  PyTorch, in query chunks so that A and dA stay bounded (a whole level-0
  A of the benchmark's unet case would take 4.3 GB), looping over points.
* `ms_deform_attn_v4_cuda` (``csrc/ms_deform_attn_v4.cu``),
  `ms_deform_attn_v4_bwd_value_cuda` and
  `ms_deform_attn_v4_bwd_loc_weight_cuda` (``csrc/ms_deform_attn_v4_bwd.cu``):
  the kernels (counted, CUDA tensors only).
* `MSDeformAttnV4Function`: the op on the card, the forward kernel and the
  backward kernels for the gradients autograd asks for.
* `ms_deform_attn_v4`: the plain forward for CPU tensors (autograd
  differentiates it), the Function for CUDA tensors.

The TPU kernels' x-major texel layout, lane padding (`_padded_cols`), MXU
expansion and fold matrices (E, Et, Ty) with their extra bf16 roundings of
the x-weights, of ``g`` and of ``wxe * dA``, and the halved tile of the
location gradient work around Mosaic, the MXU and VMEM; they are not part
of the function and are not carried over.  Shapes as `ms_deform_attn_cuda`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .cuda_build import CountedKernel, load_library, raise_on_error, stream_of
from .ms_deform_attn_cuda import (_DTYPE_CODE, _check, _level_array,
                                  launch_forward)

# A chunk of the plain version's bilinear matrix stays under this many bytes
_CHUNK_BYTES = 1 << 28
# the kernels' limits: head dim (bf16: a multiple of 16) and points per level
MAX_D = 128
MAX_P = 64


def _hat(t: torch.Tensor) -> torch.Tensor:
    return (1.0 - t.abs()).clamp_min(0.0)


def _flat(value, sampling_locations, attention_weights):
    """``value [BH, S, D]``, ``loc [BH, Q, L, P, 2]`` and ``w [BH, Q, L, P]``
    (fp32), one row per (batch, head)."""
    N, S, H, D = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    loc = sampling_locations.float().permute(0, 2, 1, 3, 4, 5)
    wts = attention_weights.float().permute(0, 2, 1, 3, 4)
    val = value.permute(0, 2, 1, 3).reshape(N * H, S, D)
    return (val, loc.reshape(N * H, Q, L, P, 2),
            wts.reshape(N * H, Q, L, P))


def _chunks(BH, Q, h, w):
    """Query slices whose ``[BH, tq, h*w]`` fp32 matrix fits the budget."""
    tq = max(1, min(Q, _CHUNK_BYTES // (BH * h * w * 4)))
    return [slice(q0, q0 + tq) for q0 in range(0, Q, tq)]


def _samples(loc, wts, lid, h, w, sl):
    """``xs, ys, aw [BH, tq, P]`` of level ``lid`` in texel coordinates."""
    xs = loc[:, sl, lid, :, 0] * w - 0.5
    ys = loc[:, sl, lid, :, 1] * h - 0.5
    return xs, ys, wts[:, sl, lid]


def _bilinear(xs, ys, aw, h, w):
    """A ``[BH, tq, h*w]`` in fp32, summed over points in order."""
    iy = torch.arange(h, dtype=torch.float32, device=xs.device)
    ix = torch.arange(w, dtype=torch.float32, device=xs.device)
    A = None
    for p in range(xs.shape[-1]):
        wy = _hat(iy - ys[..., p, None]) * aw[..., p, None]  # [BH, tq, h]
        wx = _hat(ix - xs[..., p, None])  # [BH, tq, w]
        contrib = wx[:, :, None, :] * wy[:, :, :, None]
        A = contrib if A is None else A + contrib
    return A.reshape(xs.shape[0], xs.shape[1], h * w)


def _grad_rows(grad_out, value):
    """dOut as ``[BH, Q, D]``, rounded to the value's dtype, in fp32."""
    N, S, H, D = value.shape
    g = grad_out.reshape(N, -1, H, D).permute(0, 2, 1, 3)
    return g.reshape(N * H, -1, D).to(value.dtype).float()


def ms_deform_attn_v4_plain(
    value: torch.Tensor,
    level_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    N, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    val, loc, wts = _flat(value, sampling_locations, attention_weights)
    acc = None
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        v_l = val[:, start:start + h * w].float()  # exact: value-dtype values
        parts = []
        for sl in _chunks(N * H, Q, h, w):
            A = _bilinear(*_samples(loc, wts, lid, h, w, sl), h, w)
            parts.append(torch.bmm(A.to(value.dtype).float(), v_l))
            del A
        contrib = torch.cat(parts, dim=1)  # [BH, Q, D]
        acc = contrib if acc is None else acc + contrib
        start += h * w
    out = acc.view(N, H, Q, D).permute(0, 2, 1, 3).reshape(N, Q, H * D)
    return out.to(value.dtype)


def ms_deform_attn_v4_plain_bwd_value(value, level_shapes, sampling_locations,
                                      attention_weights, grad_out):
    """``d_value = A^T g`` per level, in the value's dtype."""
    N, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    _, loc, wts = _flat(value, sampling_locations, attention_weights)
    g = _grad_rows(grad_out, value)
    parts = []
    for lid, (h, w) in enumerate(level_shapes):
        dv = torch.zeros((N * H, h * w, D), dtype=torch.float32,
                         device=value.device)
        for sl in _chunks(N * H, Q, h, w):
            A = _bilinear(*_samples(loc, wts, lid, h, w, sl), h, w)
            dv += torch.bmm(A.to(value.dtype).float().transpose(1, 2),
                            g[:, sl])
            del A
        parts.append(dv)
    d_value = torch.cat(parts, dim=1).view(N, H, S, D).permute(0, 2, 1, 3)
    return d_value.to(value.dtype).contiguous()


def _sign_on_support(t):
    """``sign(t)`` where ``|t| < 1``, else 0: the hat's derivative."""
    return torch.where(t.abs() < 1.0, torch.sign(t), torch.zeros_like(t))


def ms_deform_attn_v4_plain_bwd_loc_weight(value, level_shapes,
                                           sampling_locations,
                                           attention_weights, grad_out):
    """``(d_loc, d_w)`` from ``dA = g V^T`` and the hat's derivative, in the
    dtypes of the locations and weights.  Each point's sums fold dA over
    one texel axis first (``[BH, tq, h, w]`` against a hat of one axis), so
    nothing of shape ``[.., P, h, w]`` is built."""
    N, S, H, D = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    val, loc, wts = _flat(value, sampling_locations, attention_weights)
    g = _grad_rows(grad_out, value)
    dev = value.device
    d_loc = torch.empty((N * H, Q, L, P, 2), dtype=torch.float32, device=dev)
    d_w = torch.empty((N * H, Q, L, P), dtype=torch.float32, device=dev)
    start = 0
    for lid, (h, w) in enumerate(level_shapes):
        v_l = val[:, start:start + h * w].float()
        iy = torch.arange(h, dtype=torch.float32, device=dev)
        ix = torch.arange(w, dtype=torch.float32, device=dev)
        for sl in _chunks(N * H, Q, h, w):
            dA = torch.bmm(g[:, sl], v_l.transpose(1, 2))
            dA = dA.view(N * H, -1, h, w)
            xs, ys, aw = _samples(loc, wts, lid, h, w, sl)
            for p in range(P):
                tx = ix - xs[..., p, None]  # [BH, tq, w]
                ty = iy - ys[..., p, None]  # [BH, tq, h]
                wx, wy = _hat(tx), _hat(ty)
                gx = torch.einsum("bqyx,bqy->bqx", dA, wy)  # fold over y
                gy = torch.einsum("bqyx,bqx->bqy", dA, wx)  # fold over x
                d_w[:, sl, lid, p] = (wx * gx).sum(-1)
                d_xs = aw[..., p] * (_sign_on_support(tx) * gx).sum(-1)
                d_ys = aw[..., p] * (_sign_on_support(ty) * gy).sum(-1)
                d_loc[:, sl, lid, p, 0] = d_xs * w
                d_loc[:, sl, lid, p, 1] = d_ys * h
            del dA
        start += h * w
    d_loc = d_loc.view(N, H, Q, L, P, 2).permute(0, 2, 1, 3, 4, 5)
    d_w = d_w.view(N, H, Q, L, P).permute(0, 2, 1, 3, 4)
    return (d_loc.to(sampling_locations.dtype).contiguous(),
            d_w.to(attention_weights.dtype).contiguous())


def ms_deform_attn_v4_plain_backward(value, level_shapes, sampling_locations,
                                     attention_weights, grad_out):
    """``(d_value, d_loc, d_w)``: the plain versions of both backward
    kernels."""
    args = (value, level_shapes, sampling_locations, attention_weights,
            grad_out)
    return (ms_deform_attn_v4_plain_bwd_value(*args),
            *ms_deform_attn_v4_plain_bwd_loc_weight(*args))


def _dims(D, P, dtype):
    if D > MAX_D or P > MAX_P or (dtype == torch.bfloat16 and D % 16):
        raise ValueError(f"ms_deform_attn_v4: head dim {D} (at most "
                         f"{MAX_D}, bf16 a multiple of 16), {P} points (at "
                         f"most {MAX_P})")


def _launch(value, level_shapes, sampling_locations, attention_weights):
    """Launch the v4 forward kernel; raises on input it does not take."""
    return launch_forward("ms_deform_attn_v4_cuda", "ms_deform_attn_v4",
                          value, level_shapes, sampling_locations,
                          attention_weights, _dims)


def _bwd_fn(symbol, n_ptrs):
    fn = getattr(load_library("ms_deform_attn_v4_bwd"), symbol)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * n_ptrs \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_bwd_value(value, level_shapes, sampling_locations,
                      attention_weights, grad_out):
    """Launch the v4 value-gradient kernel: each block owns one 64-texel
    chunk of a level and writes it once, in the value's dtype."""
    name = "ms_deform_attn_v4_bwd_value"
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    _dims(D, P, value.dtype)
    grad = torch.empty_like(value)
    err = _bwd_fn("mmi_ms_deform_attn_v4_bwd_value", 4)(
        value.device.index, _DTYPE_CODE[value.dtype],
        _DTYPE_CODE[sampling_locations.dtype], sampling_locations.data_ptr(),
        attention_weights.data_ptr(), grad_out.data_ptr(), grad.data_ptr(),
        N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value))
    raise_on_error(name, err)
    return grad


def _launch_bwd_loc_weight(value, level_shapes, sampling_locations,
                           attention_weights, grad_out):
    """Launch the v4 location/weight-gradient kernel; returns ``(d_loc,
    d_w)`` in the dtypes of the locations and weights."""
    name = "ms_deform_attn_v4_bwd_loc_weight"
    N, S, Q, H, D, L, P = _check(name, value, level_shapes,
                                 sampling_locations, attention_weights,
                                 grad_out)
    _dims(D, P, value.dtype)
    dev = value.device
    d_loc = torch.empty((N, Q, H, L, P, 2), dtype=torch.float32, device=dev)
    d_w = torch.empty((N, Q, H, L, P), dtype=torch.float32, device=dev)
    err = _bwd_fn("mmi_ms_deform_attn_v4_bwd_loc_weight", 6)(
        dev.index, _DTYPE_CODE[value.dtype],
        _DTYPE_CODE[sampling_locations.dtype], value.data_ptr(),
        sampling_locations.data_ptr(), attention_weights.data_ptr(),
        grad_out.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
        N, S, Q, H, D, L, P, _level_array(level_shapes), stream_of(value))
    raise_on_error(name, err)
    return (d_loc.to(sampling_locations.dtype),
            d_w.to(attention_weights.dtype))


ms_deform_attn_v4_cuda = CountedKernel(_launch)
ms_deform_attn_v4_bwd_value_cuda = CountedKernel(_launch_bwd_value)
ms_deform_attn_v4_bwd_loc_weight_cuda = CountedKernel(_launch_bwd_loc_weight)


class MSDeformAttnV4Function(torch.autograd.Function):
    """The v4 op on the card: the forward kernel, and the two backward
    kernels for whichever gradients autograd asks for."""

    @staticmethod
    def forward(ctx, value, level_shapes, sampling_locations,
                attention_weights):
        ctx.level_shapes = level_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_v4_cuda(value, level_shapes, sampling_locations,
                                      attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, w = ctx.saved_tensors
        grad_out = grad_out.contiguous()
        d_value = d_loc = d_w = None
        if ctx.needs_input_grad[0]:
            d_value = ms_deform_attn_v4_bwd_value_cuda(
                value, ctx.level_shapes, loc, w, grad_out)
        if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
            d_loc, d_w = ms_deform_attn_v4_bwd_loc_weight_cuda(
                value, ctx.level_shapes, loc, w, grad_out)
        return d_value, None, d_loc, d_w


def ms_deform_attn_v4(value, level_shapes, sampling_locations,
                      attention_weights) -> torch.Tensor:
    """The v4 formulation: `MSDeformAttnV4Function` for CUDA tensors, the
    plain version for CPU tensors.  Returns ``[N, Q, H*D]`` in the value's
    dtype."""
    shapes = tuple((int(h), int(w)) for h, w in level_shapes)
    if value.device.type == "cuda":
        return MSDeformAttnV4Function.apply(value, shapes, sampling_locations,
                                            attention_weights)
    if value.device.type == "cpu":
        return ms_deform_attn_v4_plain(value, shapes, sampling_locations,
                                       attention_weights)
    raise ValueError(f"ms_deform_attn_v4: unsupported device {value.device}")
