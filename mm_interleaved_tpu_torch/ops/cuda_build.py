"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` holds a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (the hash covers the source and the flags, so an edit
rebuilds).  Libraries load through `ctypes`.  Nothing is built at import:
`load_library` builds at first use, and `build_all` starts one ``nvcc`` per
source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(target, tmp, process)`` or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(started) -> None:
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {target.name}:\n{out}")
    os.replace(tmp, target)


def build_all() -> List[str]:
    """Compile every source under ``csrc/`` in parallel; returns the names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = [s for s in (_start(n) for n in names) if s is not None]
    errors = []
    for s in started:
        try:
            _finish(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return names


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(started)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
