"""The deformable kernels' outputs on eight seeded shapes, saved on the card,
or two saved sets compared bit for bit: whether a change to a shared body
(the binning, the forward gather) left a kernel's bits as they were.

    python -m mm_interleaved_tpu_torch.check_deform_bits save OUT.pt
    python -m mm_interleaved_tpu_torch.check_deform_bits compare A.pt B.pt

``save`` runs kernels 1, 2 and 3 (`ops/ms_deform_attn_cuda.py`) and the v4
kernels 8a, 8b and 8c (`ops/ms_deform_attn_v4.py`; bf16 only where D is a
multiple of 16) on each case and writes their outputs, on the CPU, to
``OUT.pt``.  The cases: N 2, H 8, P 8, levels 64/32/16/8, locations over
[-0.1, 1.1] (corners outside the grid), D 16 to 128 in bf16 and fp32 with
fp32 and bf16 locations, Q 200 to 4096, each drawn from its own numpy
``RandomState``.  ``compare`` prints one line a (case, kernel) present in
both files, ``equal`` or the largest difference, then ``DIFFERING n``.
The module needs only the kernels' wrappers, so copied into an older
checkout of the package it saves that checkout's outputs: run it there
and here in one call, then compare.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

# (D, value dtype, location dtype, Q)
CASES = [(32, "bfloat16", "bfloat16", 1000), (64, "bfloat16", "float32", 4096),
         (64, "bfloat16", "bfloat16", 4096), (128, "bfloat16", "bfloat16", 700),
         (16, "float32", "float32", 900), (32, "float32", "float32", 900),
         (64, "bfloat16", "float32", 333), (96, "bfloat16", "float32", 200)]
SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))


def cases(device="cuda") -> dict:
    """``{name: (value, shapes, loc, w, grad_out)}``."""
    out = {}
    for i, (D, dt, lt, Q) in enumerate(CASES):
        rng = np.random.RandomState(100 + i)
        N, H, P = 2, 8, 8
        L, S = len(SHAPES), sum(h * w for h, w in SHAPES)

        def dev(a, t):
            return torch.tensor(a, dtype=getattr(torch, t), device=device)

        loc = rng.uniform(-0.1, 1.1, (N, Q, H, L, P, 2))
        out[f"c{i}_D{D}_{dt}_{lt}"] = (
            dev(rng.randn(N, S, H, D) * 0.5, dt), SHAPES, dev(loc, lt),
            dev(rng.rand(N, Q, H, L, P), lt), dev(rng.randn(N, Q, H * D), dt))
    return out


def save(path: str) -> None:
    from .ops import ms_deform_attn_cuda as dk
    from .ops import ms_deform_attn_v4 as v4

    res = {}
    with torch.inference_mode():
        for name, a in cases().items():
            got = dict(k1=dk.ms_deform_attn_cuda(*a[:4]),
                       k2=dk.ms_deform_attn_bwd_value_cuda(*a),
                       k3=dk.ms_deform_attn_bwd_loc_weight_cuda(*a))
            if a[0].dtype == torch.float32 or a[0].shape[-1] % 16 == 0:
                got.update(v4_fwd=v4.ms_deform_attn_v4_cuda(*a[:4]),
                           v4_dv=v4.ms_deform_attn_v4_bwd_value_cuda(*a),
                           v4_lw=v4.ms_deform_attn_v4_bwd_loc_weight_cuda(*a))
            torch.cuda.synchronize()
            res[name] = {k: tuple(x.cpu() for x in v) if isinstance(v, tuple)
                         else (v.cpu(),) for k, v in got.items()}
            print(f"saved {name}: {sorted(got)}", flush=True)
    torch.save(res, path)


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    bad = 0
    for name in a:
        for k in a[name]:
            if k not in b.get(name, {}):
                continue
            x, y = a[name][k], b[name][k]
            if all(torch.equal(p, q) for p, q in zip(x, y)):
                print(f"{name} {k}: equal")
                continue
            bad += 1
            diff = max(float((p.float() - q.float()).abs().max())
                       for p, q in zip(x, y))
            print(f"{name} {k}: DIFFER max {diff:g}")
    print(f"DIFFERING {bad}")
    return bad


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["save"] and len(argv) == 2:
        save(argv[1])
        return 0
    if argv[:1] == ["compare"] and len(argv) == 3:
        compare(argv[1], argv[2])
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
