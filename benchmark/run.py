"""The benchmark of the PyTorch port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``, each number the
check compared beside its limit (also the last lines on standard
error).  It runs on the card only: without CUDA, or with fewer cards than
the cell asks for, it exits nonzero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with few threads: the host's thread pools would only
# contend with the thread that launches the program's work
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# compile caches of the program and of any library it loads, at fixed
# paths inside the checkout (the program's own kernels build into
# build/kernels/ there)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "mm_interleaved_tpu")


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``mm_interleaved_tpu_torch`` is not
    ``mm_interleaved_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from benchmark.harness import report, spec

    cell = spec.cell(a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from benchmark.harness.runner import run

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    res = run(a.workload, a.seed, a.seconds, bool(a.trace), "cuda",
              t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    line = report.result_line(a.workload, res, bool(a.trace))
    for c in res["checks"]:
        log(f"check {c['name']}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
