"""FID — Frechet Inception Distance (counterpart of
`mm_interleaved_tpu/utils/fid.py`).

The reference's `utils/fid_score.py:251-275` math (mu/sigma feature
statistics + Frechet distance via the matrix sqrt of sigma1 @ sigma2),
copied.  The evaluation entry's feature extractor is `CLIPViTFeatures`:
the cls token of the model's own CLIP ViT (the visual tokenizer's encoder,
its weights shared), the "CLIP-FID" variant, also used for the CLIP
image-image similarity (reference `utils/clip_sim_score.py:22`); with
``projected=True`` over a `models.clip_text.CLIPVisionTower`, the image
side of the text-image rerank.  `utils.inception_v3` gives the pool3
features of the standard FID.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features: [N, D] -> (mu [D], sigma [D, D])."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD matrix via eigendecomposition."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (fid_score.py math).

    Uses sqrt(sqrt(s1) s2 sqrt(s1)) — symmetric PSD, numerically stable
    without scipy."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1 + eps * np.eye(sigma1.shape[0]))
    inner = s1_half @ (sigma2 + eps * np.eye(sigma2.shape[0])) @ s1_half
    covmean = _sqrtm_psd(inner)
    return float(
        diff @ diff + np.trace(sigma1) + np.trace(sigma2)
        - 2.0 * np.trace(covmean)
    )


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    m1, s1 = compute_statistics(real)
    m2, s2 = compute_statistics(fake)
    return frechet_distance(m1, s1, m2, s2)


class CLIPViTFeatures:
    """cls-token features of a CLIP ViT (its embeddings, pre-layernorm and
    layers): the visual tokenizer's encoder, shared with the model, for
    CLIP-FID and the CLIP image-image similarity; or, with ``projected``, a
    `models.clip_text.CLIPVisionTower` whose ``post_layernorm`` and
    ``visual_projection`` take the cls token into the space of the CLIP
    text features (HF ``CLIPModel.get_image_features``), for the
    text-image rerank.  Attention runs through the port's flash kernel on
    the card."""

    def __init__(self, encoder, batch_size: int = 32, image_size: int = None,
                 projected: bool = False):
        if projected and not hasattr(encoder, "project"):
            raise ValueError("projected features need a CLIPVisionTower "
                             "(post_layernorm and visual_projection)")
        self.encoder = encoder
        self.batch_size = batch_size
        self.projected = projected
        self.image_size = image_size or encoder.embeddings.config.image_size

    @torch.inference_mode()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """``[N, S, S, 3]`` in [0, 1] at the ViT's resolution -> the cls
        (or projected) features ``[N, D]`` in fp32."""
        from ..models.visual_tokenizer import CLIP_MEAN, CLIP_STD

        enc = self.encoder
        dev = images.device
        mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=dev)
        std = torch.tensor(CLIP_STD, dtype=images.dtype, device=dev)
        h = enc.pre_layrnorm(enc.embeddings((images - mean) / std))
        for layer in enc.layers:
            h = layer(h)
        h = h[:, 0]
        return (enc.project(h) if self.projected else h).float()

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: [N, H, W, 3] in [0,1] -> [N, D]; resizes to the ViT's
        input resolution when needed."""
        images = np.asarray(images, np.float32)
        if images.shape[1] != self.image_size:
            from PIL import Image

            s = self.image_size
            images = np.stack([
                np.asarray(Image.fromarray(
                    (im * 255).astype(np.uint8)
                ).resize((s, s), Image.BICUBIC), np.float32) / 255.0
                for im in images
            ])
        dev = self.encoder.pre_layrnorm.weight.device
        out = []
        for i in range(0, len(images), self.batch_size):
            batch = torch.from_numpy(images[i:i + self.batch_size]).to(dev)
            out.append(self.features(batch).cpu().numpy())
        return np.concatenate(out, axis=0)


def make_clip_rerank_fn(image_feature_fn: Callable,
                        text_feature_fn: Callable):
    """Candidate rerank matching `clip_rerank_generated_images`
    (clip_sim_score.py:84-120): normalised CLIP image/text features, cosine
    per (candidate, caption), argmax over candidates.

    ``images`` arrive candidate-major ([C*B, H, W, 3], candidate c of
    caption b at row c*B + b), exactly like the reference's repeated text
    features. Returns [B] best-candidate indices."""

    def rerank(images: np.ndarray, captions) -> np.ndarray:
        img_f = np.asarray(image_feature_fn(images), np.float64)
        txt_f = np.asarray(text_feature_fn(captions), np.float64)
        img_f /= np.linalg.norm(img_f, axis=-1, keepdims=True)
        txt_f /= np.linalg.norm(txt_f, axis=-1, keepdims=True)
        B = len(txt_f)
        C = len(img_f) // B
        sims = (img_f.reshape(C, B, -1) * txt_f[None]).sum(-1)  # [C, B]
        return sims.argmax(axis=0)

    return rerank


def clip_similarity(feats_a: np.ndarray, feats_b: np.ndarray) -> np.ndarray:
    """Pairwise cosine similarity rows of a vs rows of b (clip_sim_score)."""
    a = feats_a / np.linalg.norm(feats_a, axis=-1, keepdims=True)
    b = feats_b / np.linalg.norm(feats_b, axis=-1, keepdims=True)
    return (a * b).sum(axis=-1)


def clip_rerank(candidate_feats: np.ndarray, ref_feat: np.ndarray) -> int:
    """Pick the candidate most similar to the reference (the 8-candidate
    CLIP rerank of the t2i eval, clip_sim_score.py:84)."""
    sims = clip_similarity(candidate_feats, ref_feat[None].repeat(
        len(candidate_feats), axis=0
    ))
    return int(np.argmax(sims))
