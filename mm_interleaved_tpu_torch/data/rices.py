"""RICES — Retrieval-based In-Context Example Selection.

Re-design of the reference `custom_datasets/collator.py:1034-1137` (RICES):
CLIP image features over a support set, cosine-similarity top-k retrieval of
few-shot examples for a query image.  Features come from our CLIP ViT
(`utils/fid.CLIPViTFeatures`, which runs the ViT through the port's flash
kernel on the card); they are computed once and cached to disk (the
reference's ``cached_features_path``).

The port's copy of `mm_interleaved_tpu/data/rices.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np


class RICES:
    def __init__(
        self,
        dataset,  # map-style; item[0] = image array (or (enc, dec))
        feature_fn: Callable[[np.ndarray], np.ndarray],
        cached_features_path: Optional[str] = None,
        batch_size: int = 32,
    ):
        self.dataset = dataset
        self.feature_fn = feature_fn
        self.features = self._build_features(cached_features_path)

    def _image(self, item):
        img = item[0]
        return img[0] if isinstance(img, tuple) else img

    def _build_features(self, cache_path):
        if cache_path and os.path.exists(cache_path):
            return np.load(cache_path)
        imgs = np.stack([
            self._image(self.dataset[i]) for i in range(len(self.dataset))
        ])
        feats = self.feature_fn(imgs)
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.save(cache_path, feats)
        return feats

    def find(self, query_images: np.ndarray, k: int) -> List[List[int]]:
        """Top-k most similar support indices per query image."""
        q = self.feature_fn(np.asarray(query_images))
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        sims = q @ self.features.T  # [B, N]
        order = np.argsort(-sims, axis=-1)[:, :k]
        return [list(map(int, row)) for row in order]

    def get_examples(self, query_images: np.ndarray, k: int):
        """The dataset items backing the retrieved indices."""
        return [
            [self.dataset[j] for j in row]
            for row in self.find(query_images, k)
        ]
