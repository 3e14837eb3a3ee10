"""The v4 deformable kernels one at a time, on the inputs of both deformable
benchmarks, beside the gather kernels that compute the same functions.

    python -m mm_interleaved_tpu_torch.bench_v4_kernels            # card
    python -m mm_interleaved_tpu_torch.bench_v4_kernels --device cpu

The cases: `bench_deform_kernel`'s ``unet`` and ``prefill`` (as
``deform/unet``, ``deform/prefill``) and `bench_v5_kernel`'s ``unet``,
``unet-uniform``, ``prefill`` and ``prefill-uniform`` (``v5/...``), each
drawn as its benchmark draws it (bf16 values).  dOut is the benchmarks'
backward's: twice the v4 forward's output, in the value's dtype.  Timed
per case: the v4 forward (kernel 8a, ``ms_deform_attn_v4_cuda``), its value
gradient (8b) and location/weight gradient (8c), and kernels 1, 2 and 3
(`ops/ms_deform_attn_cuda.py`: forward, value gradient, location/weight
gradient) on the same inputs, the yardsticks of 8a, 8b and 8c; at the
``deform/*`` cases also the v1 forward (kernel 9,
``ms_deform_attn_v1_cuda``), whose yardstick is kernel 1 (``v1_fwd_ms``
is None at the ``v5/*`` cases, which the v1 benchmark does not run).  Each as
``<kernel>_ms``, the median of 25 synchronised CUDA-event runs, and
``<kernel>_queued_ms``, the mean of 25 calls enqueued back to back.  The
card's ``nvidia-smi`` name and power line, then one JSON row per case.

The module needs only the wrappers it times and the two benchmarks'
input draws, so copied into an older checkout of the package it measures
that checkout's kernels on the same inputs: before and after in one call.
``--device cpu`` runs the plain versions on a tiny case of each benchmark
and times nothing.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from . import bench_deform_kernel, bench_v5_kernel
from .ops import ms_deform_attn_cuda as dk
from .ops import ms_deform_attn_v1 as v1
from .ops import ms_deform_attn_v4 as v4
from .utils.timing import queued_ms, time_ms

CASES = {f"deform/{k}": ("deform", k) for k in bench_deform_kernel.CASES}
CASES.update({f"v5/{k}": ("v5", k) for k in bench_v5_kernel.CASES})
TINY = {"deform/tiny": ("deform", "tiny"), "v5/tiny": ("v5", "tiny")}


def _kernel2_plain(*a):
    return dk.ms_deform_attn_plain_backward(*a)[0]


def _kernel3_plain(*a):
    return dk.ms_deform_attn_plain_backward(*a)[1:]


# name: (kernel, plain version, takes dOut)
KERNELS = {
    "v4_fwd": (v4.ms_deform_attn_v4_cuda, v4.ms_deform_attn_v4_plain, False),
    "v4_bwd_value": (v4.ms_deform_attn_v4_bwd_value_cuda,
                     v4.ms_deform_attn_v4_plain_bwd_value, True),
    "v4_bwd_loc_weight": (v4.ms_deform_attn_v4_bwd_loc_weight_cuda,
                          v4.ms_deform_attn_v4_plain_bwd_loc_weight, True),
    "kernel1": (dk.ms_deform_attn_cuda, dk.ms_deform_attn_plain, False),
    "kernel2": (dk.ms_deform_attn_bwd_value_cuda, _kernel2_plain, True),
    "kernel3": (dk.ms_deform_attn_bwd_loc_weight_cuda, _kernel3_plain, True),
    "v1_fwd": (v1.ms_deform_attn_v1_cuda, v1.ms_deform_attn_v1_plain, False),
}
# the kernels timed only at the deformable benchmark's cases
DEFORM_ONLY = ("v1_fwd",)


def make_inputs(cases: Dict[str, tuple], device) -> dict:
    """``{case: (value, shapes, loc, w)}``, each benchmark's draw of its
    case (the deformable benchmark's cases drawn in its order)."""
    deform = {k for b, k in cases.values() if b == "deform"}
    drawn = bench_deform_kernel.make_inputs(
        {k: c for k, c in {**bench_deform_kernel.CASES,
                           **bench_deform_kernel.TINY}.items()
         if k in deform}, device)
    v5 = {**bench_v5_kernel.CASES, **bench_v5_kernel.TINY}
    return {name: drawn[k] if b == "deform" else bench_v5_kernel.make_case(
        v5[k], device) for name, (b, k) in cases.items()}


def _finite(x) -> bool:
    xs = x if isinstance(x, tuple) else (x,)
    return all(bool(torch.isfinite(t).all()) for t in xs)


def run(device="cuda", cases: Optional[Dict[str, tuple]] = None) -> list:
    """One row per case; on a CUDA device each kernel timed, on the CPU
    each plain version called once and nothing timed."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cases = CASES if cases is None else cases
    rows = []
    # no_grad, not inference_mode: kernels 2 and 3's plain versions on the
    # CPU take autograd through the plain forward
    with torch.no_grad():
        for case, args in make_inputs(cases, device).items():
            value = args[0]
            out = (v4.ms_deform_attn_v4_cuda if cuda
                   else v4.ms_deform_attn_v4_plain)(*args)
            go = (2 * out.float()).to(value.dtype)
            row = dict(case=case, device=str(device),
                       value_shape=list(value.shape),
                       loc_shape=list(args[2].shape), finite=_finite(out))
            for name, (kernel, plain, takes_grad) in KERNELS.items():
                a = args + (go,) if takes_grad else args
                if name in DEFORM_ONLY and not case.startswith("deform/"):
                    row[f"{name}_ms"] = None
                elif cuda:
                    row[f"{name}_ms"] = time_ms(lambda: kernel(*a))
                    row[f"{name}_queued_ms"] = queued_ms(lambda: kernel(*a))
                else:
                    row[f"{name}_ms"] = None
                    row["finite"] = row["finite"] and _finite(plain(*a))
            rows.append(row)
            del out, go
            if cuda:
                torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        bench_deform_kernel.print_card()
    for row in run(args.device, CASES if cuda else TINY):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
