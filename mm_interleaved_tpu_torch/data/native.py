"""ctypes bindings for the native data-path kernels (native/mmi_native.cpp).

Built on demand with g++ (no pybind11 in this image — plain extern "C" +
ctypes).  All entry points have numpy fallbacks so the pipeline works without
a toolchain; `is_available()` reports which path is active.  The library
builds into ``build/native/`` of the checkout (``MMI_NATIVE_CACHE``
overrides it), named by a hash of the source and `FLAGS`.

`FLAGS` ask for IEEE float arithmetic with no FMA contraction and no
host-specific code, so every x86-64 host and compiler computes the same
pixels: a ``-march=native`` build contracts the resampler's ``acc += w *
px`` into FMAs, which round differently, and the image tensors, and with
them a near tie of greedy tokens, then depended on the machine that built
the library.

The port's copy of `mm_interleaved_tpu/data/native.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(__file__)))


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_repo_root(), "native", "mmi_native.cpp")
        if not os.path.exists(src):
            return None
        cache = os.environ.get(
            "MMI_NATIVE_CACHE", os.path.join(_repo_root(), "build", "native"),
        )
        os.makedirs(cache, exist_ok=True)
        with open(src, "rb") as f:
            key = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
        so = os.path.join(cache, f"libmmi_native-{key.hexdigest()[:12]}.so")
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"  # processes may build at once
            try:
                subprocess.run(["g++", *FLAGS, src, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, so)
            except (OSError, subprocess.CalledProcessError):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.resize_bicubic_u8.argtypes = [u8p] + [ctypes.c_int] * 3 + [
            u8p, ctypes.c_int, ctypes.c_int,
        ]
        lib.u8_to_f32.argtypes = [u8p, f32p, ctypes.c_int64]
        lib.crop_resize_to_f32.argtypes = (
            [u8p] + [ctypes.c_int] * 7 + [f32p, ctypes.c_int, ctypes.c_int]
        )
        _LIB = lib
        return _LIB


def is_available() -> bool:
    return _build_and_load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def resize_bicubic(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """HWC uint8 -> HWC uint8 Catmull-Rom bicubic resize."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    sh, sw, c = src.shape
    lib = _build_and_load()
    if lib is None:
        from PIL import Image

        return np.asarray(
            Image.fromarray(src).resize((dw, dh), Image.BICUBIC)
        )
    dst = np.empty((dh, dw, c), np.uint8)
    lib.resize_bicubic_u8(
        _ptr(src, ctypes.c_uint8), sh, sw, c,
        _ptr(dst, ctypes.c_uint8), dh, dw,
    )
    return dst


def crop_resize_to_f32(
    src: np.ndarray, top: int, left: int, crop_h: int, crop_w: int,
    dh: int, dw: int,
) -> np.ndarray:
    """Fused crop + bicubic resize + [0,1] float conversion."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    sh, sw, c = src.shape
    lib = _build_and_load()
    if lib is None:
        from PIL import Image

        img = Image.fromarray(src).crop(
            (left, top, left + crop_w, top + crop_h)
        ).resize((dw, dh), Image.BICUBIC)
        return np.asarray(img, np.float32) / 255.0
    dst = np.empty((dh, dw, c), np.float32)
    lib.crop_resize_to_f32(
        _ptr(src, ctypes.c_uint8), sh, sw, c,
        top, left, crop_h, crop_w,
        _ptr(dst, ctypes.c_float), dh, dw,
    )
    return dst


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.uint8)
    lib = _build_and_load()
    if lib is None:
        return src.astype(np.float32) / 255.0
    dst = np.empty(src.shape, np.float32)
    lib.u8_to_f32(
        _ptr(src, ctypes.c_uint8), _ptr(dst, ctypes.c_float), src.size
    )
    return dst
