"""IO loaders (reference `custom_datasets/loader.py:13-81`): local filesystem
now; the interface leaves room for object-store clients (the reference's
ceph-style client).

The port's copy of `mm_interleaved_tpu/data/loader.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import io

from PIL import Image


class LocalLoader:
    def load_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def load_image(self, path: str) -> Image.Image:
        img = Image.open(io.BytesIO(self.load_bytes(path)))
        return img.convert("RGB")
