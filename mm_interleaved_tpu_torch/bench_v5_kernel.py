"""v4 against v5 deformable attention on the card, forward and forward +
backward (counterpart of `scripts/bench_v5_kernel.py`).

    python -m mm_interleaved_tpu_torch.bench_v5_kernel            # card
    python -m mm_interleaved_tpu_torch.bench_v5_kernel --device cpu

v4 is the dense bilinear-matrix formulation (`ops/ms_deform_attn_v4.py`:
its forward kernel and two backward kernels); v5 is the port's production
op, `ops/ms_deform_attn.py` (kernel 1 and its two backward kernels).  The
cases are the script's: ``unet`` (B 4, Q 4096, levels 64/32/16/8, P 8,
H 16, D 64, each query's locations within 1/64 of its cell of a 64 x 64
grid) and ``prefill`` (B 16, Q 512, levels 32/16/8, locations within 3/16
of the centre), realistic clustered locations, and each again with the
locations redrawn uniformly from [0.02, 0.98] (``-uniform``).  Each case
draws from a fresh numpy ``RandomState(0)`` in the script's order:
clustered locations, the uniform ones, the value (``randn * 0.1`` in
bf16), the weights (``rand``).

Forward + backward is the gradient of ``(out.float() ** 2).sum()`` with
respect to value, locations and weights.  On the card each of the four
calls is timed with CUDA events, the median of ``RUNS`` after a warm-up
(the script's chains of dependent calls worked around a relay and are not
needed here).  One JSON row per case: the times and their v4 / v5 ratios,
and each output's largest |v4 - v5| over v4's largest magnitude.  The
location gradient is compared away from the hat's kinks (`kinks`), where
neither formulation's derivative is the gradient.  ``--device cpu`` runs
the plain versions on the tiny cases (no timing: a CPU time says nothing
of the card).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from .bench_deform_kernel import RUNS, SEED, print_card, time_ms
from .ops.ms_deform_attn import ms_deform_attn
from .ops.ms_deform_attn_v4 import ms_deform_attn_v4

_UNET = dict(B=4, Q=4096, shapes=((64, 64), (32, 32), (16, 16), (8, 8)),
             P=8, H=16, D=64, cluster="grid")
_PREFILL = dict(B=16, Q=512, shapes=((32, 32), (16, 16), (8, 8)), P=8, H=16,
                D=64, cluster="centre")
CASES = {
    "unet": dict(_UNET, uniform=False),
    "unet-uniform": dict(_UNET, uniform=True),
    "prefill": dict(_PREFILL, uniform=False),
    "prefill-uniform": dict(_PREFILL, uniform=True),
}
# small enough for the CPU: non-square levels, each way of drawing locations
_TINY = dict(B=2, Q=16, shapes=((6, 8), (3, 4)), P=4, H=2, D=16)
TINY = {
    "tiny": dict(_TINY, cluster="grid", uniform=False),
    "tiny-centre": dict(_TINY, cluster="centre", uniform=False),
    "tiny-uniform": dict(_TINY, cluster="grid", uniform=True),
}
FORMULATIONS = {"v4": ms_deform_attn_v4, "v5": ms_deform_attn}
CALLS = ("v4_fwd", "v5_fwd", "v4_fwd_bwd", "v5_fwd_bwd")


def make_case(c: dict, device):
    """``(value, shapes, loc, w)`` of one case, drawn as the script's
    ``make_case`` draws it."""
    rng = np.random.RandomState(SEED)
    B, Q, H, D, P = c["B"], c["Q"], c["H"], c["D"], c["P"]
    shapes = tuple(c["shapes"])
    L, S = len(shapes), sum(h * w for h, w in shapes)
    size = (B, Q, H, L, P, 2)
    if c["cluster"] == "grid":  # around the centre of the query's cell
        g = int(round(Q ** 0.5))
        gy, gx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        ref = np.stack([(gx + .5) / g, (gy + .5) / g], -1).reshape(1, Q, 2)
        loc = ref[:, :, None, None, None, :] + rng.uniform(-1 / g, 1 / g,
                                                           size)
    else:
        loc = 0.5 + rng.uniform(-3 / 16, 3 / 16, size)
    if c["uniform"]:
        loc = rng.uniform(0.02, 0.98, size)
    value = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32) * .1)
    loc = torch.from_numpy(loc.astype(np.float32))
    w = torch.from_numpy(rng.rand(B, Q, H, L, P).astype(np.float32))
    return (value.to(torch.bfloat16).to(device), shapes, loc.to(device),
            w.to(device))


def make_inputs(cases: Dict[str, dict], device) -> dict:
    return {name: make_case(c, device) for name, c in cases.items()}


def kinks(loc: torch.Tensor, shapes) -> torch.Tensor:
    """``[N, Q, H, L, P, 2]`` bool: where a sample's coordinate in texels
    (``loc * size - 0.5`` in fp32) is a whole number.  The hat has a kink
    there: v4's derivative takes sign(0) = 0 and the gather's floor-based
    blend a one-sided slope, and neither is the gradient."""
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=loc.device)
    t = loc.float() * size[:, None, :] - 0.5
    return t == torch.floor(t)


def _rel(got, ref) -> float:
    """Largest |got - ref| over ref's largest magnitude."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def run(device="cuda", cases: Optional[Dict[str, dict]] = None) -> dict:
    """Run v4 and v5, forward and forward + backward, on every case;
    returns ``rows`` (one dict per case), ``calls`` (the calls made of each
    of `CALLS`), and the ``inputs`` and ``outputs`` (``{case: {"v4": out,
    "v5": out, "v4_grads": (d_value, d_loc, d_w), "v5_grads": ...}}``).  On
    a CUDA device each call is made once for its output (the warm-up) and
    ``RUNS`` times more to be timed; on the CPU once."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cases = CASES if cases is None else cases
    inputs = make_inputs(cases, device)
    rows, outputs = [], {}
    calls = dict.fromkeys(CALLS, 0)
    for case, (value, shapes, loc, w) in inputs.items():

        def fwd(fn):
            with torch.inference_mode():
                return fn(value, shapes, loc, w)

        def fwd_bwd(fn):
            ins = [t.detach().requires_grad_() for t in (value, loc, w)]
            out = fn(ins[0], shapes, ins[1], ins[2])
            return torch.autograd.grad((out.float() ** 2).sum(), ins)

        outs, ms = {}, {}
        for form, fn in FORMULATIONS.items():
            for kind, call in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                key = f"{form}_{kind}"
                outs[key] = call(fn)
                calls[key] += 1
                if cuda:
                    torch.cuda.synchronize()
                    ms[key] = time_ms(lambda: call(fn))
                    calls[key] += RUNS
        g4, g5 = outs["v4_fwd_bwd"], outs["v5_fwd_bwd"]
        smooth = ~kinks(loc, shapes)
        row = dict(case=case, device=str(device),
                   value_shape=list(value.shape), loc_shape=list(loc.shape))
        for kind in ("fwd", "fwd_bwd"):
            t4, t5 = ms.get(f"v4_{kind}"), ms.get(f"v5_{kind}")
            row.update({f"{kind}_v4_ms": t4, f"{kind}_v5_ms": t5,
                        f"{kind}_ratio": t4 / t5 if cuda else None})
        row.update(
            rel_diff_fwd=_rel(outs["v5_fwd"], outs["v4_fwd"]),
            rel_diff_d_value=_rel(g5[0], g4[0]),
            rel_diff_d_loc=_rel(g5[1] * smooth, g4[1] * smooth),
            rel_diff_d_w=_rel(g5[2], g4[2]),
            kinks=int((~smooth).sum()),
            finite=all(bool(torch.isfinite(t).all())
                       for t in (outs["v4_fwd"], *g4)),
        )
        rows.append(row)
        outputs[case] = dict(v4=outs["v4_fwd"], v5=outs["v5_fwd"],
                             v4_grads=g4, v5_grads=g5)
    return dict(rows=rows, calls=calls, inputs=inputs, outputs=outputs)


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
