"""The Python half of the GroupNorm(+SiLU) kernels and of the deformable
location/weight gradient's Hopper body, on the CPU.

* `GroupNormSiLUFunction` (the op's autograd function, plain versions on
  a CPU tensor, backward by recompute through them) against ``jax.vjp``
  of the JAX package's `group_norm_silu` and `group_norm`: the output and
  the gradients of x, scale and bias, within 1e-5 of each one's scale;
* `gn_plan`, the grid both GroupNorm kernels run: the chunks and row
  groups of ``csrc/group_norm_silu.cu`` cover every row of every batch
  once, at ragged spatial sizes, and a CTA holds at least one whole warp;
* `loc_weight_variant`, kernel 3's body by (D, dtype);
* the wrappers refuse a view off a 16-byte boundary at the vector widths,
  and a CPU tensor, before any launch.

The kernels themselves are checked on the card (`chip_smoke.py`, phases
7 and 8c: the captured sites, `GN_EDGES` and `DEFORM_BWD_EDGES`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.ops.group_norm import (
    group_norm as j_gn, group_norm_silu as j_gn_silu,
)
from mm_interleaved_tpu_torch.ops import group_norm as tgn
from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as kmod

from _torch_parity import t

BF16, FP32 = torch.bfloat16, torch.float32


def _close_scaled(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape,G,eps", [
    ((2, 6, 6, 320), 32, 1e-5),  # the flagship's width: 10 channels a group
    ((2, 8, 8, 32), 4, 1e-6),
])
def test_group_norm_function_grads_match_jax(shape, G, eps, silu):
    """Output and d(x, scale, bias) of the port's function against
    ``jax.vjp`` through the JAX op (its XLA path on the CPU)."""
    rs = np.random.RandomState(3)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    bias = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    dout = rs.randn(*shape).astype(np.float32)
    jfn = j_gn_silu if silu else j_gn
    want_y, vjp = jax.vjp(lambda a, b, c: jfn(a, b, c, G, eps),
                          jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(bias))
    want = vjp(jnp.asarray(dout))
    ins = [t(a).requires_grad_(True) for a in (x, scale, bias)]
    out = tgn.GroupNormSiLUFunction.apply(*ins, G, eps, silu)
    assert type(out.grad_fn).__name__ == "GroupNormSiLUFunctionBackward"
    _close_scaled(out, want_y)
    out.backward(t(dout))
    for a, wnt in zip(ins, want):
        _close_scaled(a.grad, wnt)


def _rows_covered(B, N, C, dtype):
    """Each row's visits under the kernels' mapping: chunk k of a batch
    takes rows [k * rows, (k + 1) * rows), its row group rg every R-th of
    them from rg."""
    width, threads, chunks, rows = tgn.gn_plan(B, N, C, dtype)
    R = threads // (C // width)
    seen = np.zeros(N, np.int64)
    for k in range(chunks):
        for rg in range(R):
            r = np.arange(k * rows + rg, min(N, (k + 1) * rows), R)
            np.add.at(seen, r, 1)
    return seen, (width, threads, chunks, rows, R)


@pytest.mark.parametrize("B,N,C,dtype", [
    (8, 4096, 320, BF16),    # UNet 64 px
    (8, 64, 2560, BF16),     # UNet 8 px, the widest up block
    (4, 512 * 512 + 3, 128, BF16),  # ragged, VAE width
    (4, 262144, 128, FP32),  # the fp32 VAE encode at 512 px
    (1, 1, 320, BF16),       # one row
    (3, 7, 20, BF16),        # the scalar body
    (2, 1000, 24, FP32),
    (1, 999, 4096, BF16),    # the widest C taken
    (2, 256, 192, BF16),     # 504 threads: a last warp of 24 lanes
])
def test_gn_plan_covers_every_row_once(B, N, C, dtype):
    seen, (width, threads, chunks, rows, R) = _rows_covered(B, N, C, dtype)
    assert (seen == 1).all()
    assert width == tgn.gn_width(C, dtype)
    assert C % width == 0 and threads % (C // width) == 0
    assert R >= 1 and 32 <= threads <= 1024
    assert (chunks - 1) * rows < N <= chunks * rows


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_gn_plan_gives_a_whole_warp_at_every_width(dtype):
    """The moments kernel folds groups with full-warp shuffles in the
    block's whole warps only; the kernel refuses a plan without one."""
    for C in range(1, 4097):
        if C // tgn.gn_width(C, dtype) > 1024:
            continue  # refused (`test_gn_plan_refuses_too_many_channels`)
        width, threads, _, _ = tgn.gn_plan(2, 64, C, dtype)
        assert threads >= 32 and threads % (C // width) == 0, (C, threads)


@pytest.mark.parametrize("C,dtype,width", [
    (320, BF16, 8), (640, BF16, 8), (20, BF16, 1), (12, BF16, 1),
    (320, FP32, 4), (10, FP32, 1), (128, FP32, 4),
])
def test_gn_width_by_channels_and_dtype(C, dtype, width):
    assert tgn.gn_width(C, dtype) == width


def test_gn_plan_refuses_too_many_channels():
    with pytest.raises(ValueError, match="channels"):
        tgn.gn_plan(1, 16, 4104, BF16)


@pytest.mark.parametrize("D,dtype,want", [
    (64, BF16, "grouped"),   # the flagship: 8 lanes a sample
    (32, BF16, "grouped"), (128, BF16, "grouped"),  # 4 and 16 lanes
    (8, BF16, "warp"), (16, BF16, "warp"),  # 1 and 2 vectors
    (256, BF16, "warp"),     # 32 vectors: a whole warp a sample
    (512, BF16, "warp"),     # more than a warp
    (20, BF16, "warp"),      # not whole 16-byte vectors
    (24, BF16, "warp"),      # 3 vectors
    (64, FP32, "grouped"), (16, FP32, "grouped"), (8, FP32, "warp"),
    (128, FP32, "warp"), (6, FP32, "warp"), (256, FP32, "warp"),
])
def test_loc_weight_variant_by_width_and_dtype(D, dtype, want):
    assert kmod.loc_weight_variant(D, dtype) == want


def _misaligned(x):
    """A contiguous copy of ``x`` that starts off a 16-byte boundary."""
    buf = torch.zeros(x.numel() + 8, dtype=x.dtype)
    start = next(i for i in range(1, 8)
                 if (buf.data_ptr() + i * x.element_size()) % 16)
    return buf[start:start + x.numel()].view(x.shape).copy_(x)


def _deform_args(D, dtype=BF16):
    shapes = ((4, 4),)
    return [torch.zeros(1, 16, 2, D, dtype=dtype), shapes,
            torch.zeros(1, 3, 2, 1, 2, 2, dtype=dtype),
            torch.zeros(1, 3, 2, 1, 2, dtype=dtype),
            torch.zeros(1, 3, 2 * D, dtype=dtype)]


def _gn_calls(C, dtype):
    x = torch.zeros(2, 3, 3, C, dtype=dtype)
    p = torch.ones(C, dtype=BF16)
    return [(tgn.group_norm_moments_cuda, [x, p, p, 4, 1e-5]),
            (tgn.group_norm_apply_cuda, [x, torch.zeros(2, 2, C), True])]


@pytest.mark.parametrize("case,match", [
    ("gn_bf16_c320", "16-byte"), ("gn_fp32_c64", "16-byte"),
    ("gn_scalar_c20", "CUDA"),   # the scalar body takes any alignment
    ("k3_d64", "16-byte"), ("k3_fp32_d64", "16-byte"),
    ("k3_warp_d20", "CUDA"),     # the warp body takes any alignment
])
def test_misaligned_views_refused_before_any_launch(case, match):
    """A contiguous view off a 16-byte boundary raises where the chosen body
    loads 16-byte vectors (no slower body is taken instead), and passes on
    to the device check where it does not; no launch is counted."""
    calls = {
        "gn_bf16_c320": _gn_calls(320, BF16),
        "gn_fp32_c64": _gn_calls(64, FP32),
        "gn_scalar_c20": _gn_calls(20, BF16),
    }.get(case)
    if calls is None:
        D, dtype = dict(k3_d64=(64, BF16), k3_fp32_d64=(64, FP32),
                        k3_warp_d20=(20, BF16))[case]
        calls = [(kmod.ms_deform_attn_bwd_loc_weight_cuda, _deform_args(
            D, dtype))]
    for kernel, args in calls:
        args = list(args)
        args[0] = _misaligned(args[0])
        assert args[0].is_contiguous() and args[0].data_ptr() % 16
        before = kernel.launches
        with pytest.raises(ValueError, match=match):
            kernel(*args)
        assert kernel.launches == before


def test_gn_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """CPU tensors raise at the device check; scale/bias of another width,
    a channel count the groups do not divide, or a wrong ``wb`` raise
    before it; nothing is counted."""
    x = torch.zeros(2, 3, 3, 32)
    p = torch.ones(32)
    cases = [
        (tgn.group_norm_moments_cuda, (x, p, p, 4, 1e-5), "CUDA"),
        (tgn.group_norm_apply_cuda, (x, torch.zeros(2, 2, 32), False),
         "CUDA"),
        (tgn.group_norm_moments_cuda, (x, torch.ones(16), p, 4, 1e-5),
         "scale/bias"),
        (tgn.group_norm_moments_cuda, (x, p, p, 5, 1e-5), "groups"),
        (tgn.group_norm_apply_cuda, (x, torch.zeros(2, 32), True), "wb"),
    ]
    for kernel, args, match in cases:
        before = kernel.launches
        with pytest.raises(ValueError, match=match):
            kernel(*args)
        assert kernel.launches == before


def test_gn_edges_reach_a_partial_last_warp():
    """`chip_smoke.py`'s `GN_EDGES` take the widths they list, and the
    C = 192 cases run a CTA whose last warp is partial, with more groups
    than whole warps: the layout the fold by group must get right."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    partial = []
    for name, (B, px, C, G, dt, _, width) in smoke.GN_EDGES.items():
        plan = tgn.gn_plan(B, px * px, C, getattr(torch, dt))
        assert plan[0] == width, name
        if plan[1] % 32 and G > plan[1] // 32:
            partial.append(name)
    assert sorted(partial) == ["c192_g16", "c192_g32"]
