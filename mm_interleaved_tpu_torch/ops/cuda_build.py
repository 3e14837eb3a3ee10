"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` holds a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (the hash covers the source and the flags, so an edit
rebuilds).  Libraries load through `ctypes`.  Nothing is built at import:
`load_library` builds at first use, and `build_all` starts one ``nvcc`` per
source at once and waits for all of them.

The launch helpers at the end are shared by the kernels' wrappers:
`CountedKernel` counts launches, `check_cuda` and `forbid_grad` refuse
what a kernel does not take, `needs_grad` tells whether autograd records a
call (the autograd functions and the training-only routes decide on it),
`raise_on_error` turns a nonzero return into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import torch

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


class CountedKernel:
    """A kernel's wrapper: calling it launches the kernel through
    ``launch``; ``launches`` counts the launches made (one that raises is
    not counted)."""

    def __init__(self, launch):
        self._launch = launch
        self.launches = 0
        self.__doc__ = launch.__doc__

    def __call__(self, *args, **kwargs):
        out = self._launch(*args, **kwargs)
        self.launches += 1
        return out


def check_cuda(name: str, tensors: Sequence[torch.Tensor],
               dtypes=(torch.float32, torch.bfloat16)) -> None:
    """All of ``tensors`` on one CUDA device, contiguous, the first in one
    of ``dtypes``."""
    dev = tensors[0].device
    if any(t.device.type != "cuda" or t.device != dev for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    if tensors[0].dtype not in dtypes:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} not in {dtypes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None entries are
    skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def forbid_grad(name: str, *tensors: torch.Tensor) -> None:
    """A bare forward launch has no backward: refuse a call that autograd
    would have to differentiate (a differentiable kernel goes through its
    `torch.autograd.Function`, whose forward runs with grad disabled)."""
    if needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the bare CUDA forward has no gradient; differentiate "
            "through its autograd function or the training-only route")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
