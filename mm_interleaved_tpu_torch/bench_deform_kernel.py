"""Deformable-kernel comparison on the card: the v1 (separable) and v4
(bilinear-matrix) formulations against kernel 1, the gather of
`ops/ms_deform_attn.py` (counterpart of `scripts/bench_deform_kernel.py`).
v4 keeps its numerics (A rounded after the sum over the points); on the
card its forward is a per-query gather of A's non-zero entries.

    python -m mm_interleaved_tpu_torch.bench_deform_kernel            # card
    python -m mm_interleaved_tpu_torch.bench_deform_kernel --device cpu

The cases are the script's: ``unet`` (B 4, Q 4096, levels 64/32/16/8,
P 8, H 16, D 64) and ``prefill`` (B 16, Q 512, levels 32/16/8), their
inputs drawn from one numpy ``RandomState(0)`` in that order, as the script
draws them (value ``randn`` in bf16, locations and weights ``rand``).  Each
formulation runs through its dispatcher; on the card each call is timed
with CUDA events, the median of ``RUNS`` after a warm-up (the script's
chains of dependent calls worked around a relay and are not needed here).
One JSON row per case and formulation: ``ms``, ``speedup_vs_v1``, and
``rel_diff_vs_kernel1``, the largest |out - kernel 1| over kernel 1's
largest |out|.  ``--device cpu`` runs the plain versions on the ``tiny``
case instead (no timing: a CPU time says nothing of the card).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from .ops.ms_deform_attn import ms_deform_attn
from .ops.ms_deform_attn_v1 import ms_deform_attn_v1
from .ops.ms_deform_attn_v4 import ms_deform_attn_v4
from .utils.timing import card_line

CASES = {
    "unet": dict(B=4, Q=4096, shapes=((64, 64), (32, 32), (16, 16), (8, 8)),
                 P=8, H=16, D=64),
    "prefill": dict(B=16, Q=512, shapes=((32, 32), (16, 16), (8, 8)), P=8,
                    H=16, D=64),
}
# small enough for the CPU: non-square levels, out of the benchmark's shapes
TINY = {"tiny": dict(B=2, Q=50, shapes=((12, 16), (6, 8), (3, 4)), P=4, H=2,
                     D=16)}
FORMULATIONS = {"v1": ms_deform_attn_v1, "v4": ms_deform_attn_v4,
                "kernel1": ms_deform_attn}
RUNS = 25
SEED = 0


def make_inputs(cases: Dict[str, dict], device) -> dict:
    """``{case: (value, shapes, loc, w)}``, drawn in the order of ``cases``
    from one ``RandomState(SEED)``: value bf16, locations and weights
    fp32."""
    rng = np.random.RandomState(SEED)
    out = {}
    for name, c in cases.items():
        B, Q, H, D, P = c["B"], c["Q"], c["H"], c["D"], c["P"]
        shapes = tuple(c["shapes"])
        S, L = sum(h * w for h, w in shapes), len(shapes)
        value = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
        loc = torch.from_numpy(rng.rand(B, Q, H, L, P, 2).astype(np.float32))
        w = torch.from_numpy(rng.rand(B, Q, H, L, P).astype(np.float32))
        out[name] = (value.to(torch.bfloat16).to(device), shapes,
                     loc.to(device), w.to(device))
    return out


def time_ms(fn) -> float:
    """Median of ``RUNS`` CUDA-event timings of ``fn`` (already warm)."""
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run(device="cuda", cases: Optional[Dict[str, dict]] = None) -> dict:
    """Run every formulation on every case; returns ``rows`` (one dict per
    case and formulation), ``calls`` (the calls made of each formulation),
    and the ``inputs`` and ``outputs`` (``{case: {formulation: out}}``).  On
    a CUDA device each formulation is called once for its output (the
    warm-up) and ``RUNS`` times more to be timed; on the CPU once."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cases = CASES if cases is None else cases
    inputs = make_inputs(cases, device)
    rows, outputs = [], {}
    calls = dict.fromkeys(FORMULATIONS, 0)
    with torch.inference_mode():
        for case, args in inputs.items():
            outs, ms = {}, {}
            for form, fn in FORMULATIONS.items():
                outs[form] = fn(*args)
                calls[form] += 1
                if cuda:
                    torch.cuda.synchronize()
                    ms[form] = time_ms(lambda: fn(*args))
                    calls[form] += RUNS
            ref = outs["kernel1"].float()
            scale = float(ref.abs().max())
            for form, out in outs.items():
                diff = float((out.float() - ref).abs().max())
                rows.append(dict(
                    case=case, formulation=form, device=str(device),
                    value_shape=list(args[0].shape),
                    ms=ms.get(form),
                    speedup_vs_v1=(ms["v1"] / ms[form] if cuda else None),
                    rel_diff_vs_kernel1=diff / max(scale, 1e-30),
                    finite=bool(torch.isfinite(out).all()),
                ))
            outputs[case] = outs
    return dict(rows=rows, calls=calls, inputs=inputs, outputs=outputs)


def print_card() -> None:
    """One JSON line: the card's name and its ``nvidia-smi`` name and power
    limit, which every time printed after it belongs to."""
    print(json.dumps({"device": torch.cuda.get_device_name(),
                      "nvidia_smi": card_line()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        print_card()
    res = run(args.device, CASES if cuda else TINY)
    for row in res["rows"]:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
