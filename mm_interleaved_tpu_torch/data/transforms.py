"""Image transforms.

Re-design of the reference `custom_datasets/utils.py:405-562`
(`create_transform` / `transform_numpy` / `dual_transform`): host-side
preprocessing producing channels-last float arrays in [0, 1] (the model
normalises on device — CLIP stats in the visual tokenizer, [-1, 1] in the SD
VAE).

The hot path is the native fused crop+bicubic-resize kernel
(`native/mmi_native.cpp`, PIL-compatible antialiased resampling) with a PIL
fallback when no toolchain is available.

Modes mirror the reference:
  * "numpy"        -> resize(+center-crop) to one resolution;
  * "dual_numpy"   -> (encoder_res, decoder_res) pair for the two-resolution
                      pathway (224 enc / 512 dec, utils.py:440-452);
  * "flip"/"resize" variants with optional random horizontal flip.

The port's copy of `mm_interleaved_tpu/data/transforms.py` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
from PIL import Image

from . import native

ImageLike = Union[Image.Image, np.ndarray]


def _to_u8(img: ImageLike) -> np.ndarray:
    if isinstance(img, Image.Image):
        return np.asarray(img.convert("RGB"), dtype=np.uint8)
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    return arr


def _crop_box(h: int, w: int, random_crop: bool,
              rng: Optional[np.random.RandomState]) -> Tuple[int, int, int]:
    """(top, left, side) of the square crop."""
    side = min(h, w)
    if random_crop and rng is not None:
        top = rng.randint(0, h - side + 1)
        left = rng.randint(0, w - side + 1)
    else:
        top, left = (h - side) // 2, (w - side) // 2
    return top, left, side


@dataclasses.dataclass
class ImageTransform:
    """Single-resolution transform (reference "numpy"/"resize" modes)."""

    size: int = 224
    center_crop: bool = True
    random_flip: bool = False
    random_crop: bool = False

    def __call__(self, img: ImageLike,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        arr = _to_u8(img)
        if self.random_flip and rng is not None and rng.rand() < 0.5:
            arr = arr[:, ::-1]
        h, w = arr.shape[:2]
        if self.center_crop or self.random_crop:
            top, left, side = _crop_box(h, w, self.random_crop, rng)
            return native.crop_resize_to_f32(
                arr, top, left, side, side, self.size, self.size
            )
        return native.crop_resize_to_f32(
            arr, 0, 0, h, w, self.size, self.size
        )


@dataclasses.dataclass
class DualImageTransform:
    """Two-resolution transform (encoder 224 / decoder 512,
    reference utils.py:474-515). The same geometric crop/flip drives both
    outputs so they stay aligned."""

    encoder_size: int = 224
    decoder_size: int = 512
    random_flip: bool = False
    random_crop: bool = False

    def __call__(self, img: ImageLike,
                 rng: Optional[np.random.RandomState] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        arr = _to_u8(img)
        if self.random_flip and rng is not None and rng.rand() < 0.5:
            arr = arr[:, ::-1]
        h, w = arr.shape[:2]
        top, left, side = _crop_box(h, w, self.random_crop, rng)
        enc = native.crop_resize_to_f32(
            arr, top, left, side, side, self.encoder_size, self.encoder_size
        )
        dec = native.crop_resize_to_f32(
            arr, top, left, side, side, self.decoder_size, self.decoder_size
        )
        return enc, dec


def to_array(img: ImageLike) -> np.ndarray:
    return native.u8_to_f32(_to_u8(img))


def create_transform(aug_type: str = "numpy", resolution: int = 224,
                     resolution2: int = 512, random_crop: bool = False,
                     random_flip: bool = False):
    """Factory matching the reference's `create_transform` surface
    (utils.py:405-471)."""
    if aug_type in ("numpy", "flip", "resize", "numpy_grounding"):
        return ImageTransform(
            size=resolution,
            center_crop=aug_type != "resize",
            random_flip=random_flip or aug_type == "flip",
            random_crop=random_crop,
        )
    if aug_type == "dual_numpy":
        return DualImageTransform(
            encoder_size=resolution, decoder_size=resolution2,
            random_flip=random_flip, random_crop=random_crop,
        )
    raise ValueError(aug_type)
