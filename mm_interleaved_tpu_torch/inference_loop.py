"""Multi-turn interleaved inference: text and image generation in turn
(counterpart of `mm_interleaved_tpu/inference_loop.py`).

  * each turn either decodes text (greedy, stopping at <eos> or <soi>) or
    samples an image conditioned on the whole prefix;
  * when a text turn ends in <soi> (or an image is forced), the stream
    gains the <soi> + N x <image> block and a grey placeholder image, and
    the next turn generates that image;
  * a generated image is re-encoded (`ImageTransform` -> the visual
    tokenizer) as context for the turns after it;
  * prompts are left-padded to a multiple of 64, as in the JAX loop.

The image turns draw from one `torch.Generator` seeded with ``cfg.seed``
(the JAX loop splits a ``PRNGKey``); the runtime's `denoise` also takes
injected draws.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from .data.transforms import ImageTransform
from .generation.text import TextGenerationConfig
from .parallel.inference import LocalGenerator


def _bucket(n: int, mult: int = 64) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass
class InferenceConfig:
    num_iter: int = 2
    start_mode: str = "generate_texts"
    max_new_tokens: int = 64
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    force_image_every_turn: bool = False
    seed: int = 0


class InterleavedInferencePipeline:
    def __init__(self, model, tokenizer, cfg: InferenceConfig, runtime=None):
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.runtime = runtime or LocalGenerator(model)
        self.device = next(model.parameters()).device
        mcfg = model.cfg
        self.sp = mcfg.special
        self.ntok = mcfg.num_img_token
        self.enc_res = mcfg.visual.encoder.vit.image_size
        self.transform = ImageTransform(size=self.enc_res)

    # annt.json loading (reference inference.py:39-115)

    def load_annt_data(self, annt_path: str, image_root: str = ""):
        """annt.json: [{"sentences": [...], "images": [paths...]}], an
        image wherever a sentence is "<|image|>"."""
        with open(annt_path) as f:
            annts = json.load(f)
        samples = []
        for annt in annts:
            ids: List[int] = [self.sp.bos_token_id]
            images: List[np.ndarray] = []
            image_paths = annt.get("images", [])
            img_i = 0
            for piece in annt.get("sentences", []):
                if piece == "<|image|>":
                    ids += [self.sp.soi_token_id] + (
                        [self.sp.image_token_id] * self.ntok)
                    img = Image.open(
                        os.path.join(image_root, image_paths[img_i])
                    ).convert("RGB")
                    images.append(self.transform(img))
                    img_i += 1
                else:
                    ids += self.tokenizer.encode(piece)
            samples.append(dict(
                text_ids=np.asarray(ids, np.int32),
                images=images,
                meta=annt.get("meta", {}),
            ))
        return samples

    def _batchify(self, ids: np.ndarray, images: List[np.ndarray]):
        """One left-padded row on the device."""
        L = _bucket(len(ids))
        pad = L - len(ids)
        text_ids = np.concatenate([
            np.full((pad,), self.sp.pad_token_id, np.int64), ids])[None]
        att = np.concatenate([
            np.zeros((pad,), np.int32), np.ones((len(ids),), np.int32)])[None]
        max_img = max(len(images), 1)
        img_arr = np.zeros((1, max_img, self.enc_res, self.enc_res, 3),
                           np.float32)
        for i, im in enumerate(images):
            img_arr[0, i] = im
        dev = self.device
        return dict(
            text_ids=torch.from_numpy(text_ids).to(dev),
            attention_mask=torch.from_numpy(att).to(dev),
            image_tensors=torch.from_numpy(img_arr).to(dev),
            num_image_per_seq=torch.tensor([max_img], device=dev),
        )

    def _grey_image(self):
        return np.full((self.enc_res, self.enc_res, 3), 0.5, np.float32)

    def run(self, sample: Dict,
            generator: Optional[torch.Generator] = None) -> Dict:
        """The multi-turn loop (reference inference_all, inference.py:199-279)."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed)
        ids = np.asarray(sample["text_ids"], np.int64).copy()
        images = list(sample["images"])
        mode = cfg.start_mode
        outputs = {"texts": [], "images": []}
        stops = (self.sp.eos_token_id, self.sp.soi_token_id)

        for _ in range(cfg.num_iter):
            batch = self._batchify(ids, images)
            if mode == "generate_texts":
                gen_cfg = TextGenerationConfig(
                    max_new_tokens=cfg.max_new_tokens, eos_token_ids=stops,
                    pad_token_id=self.sp.pad_token_id)
                toks = self.runtime.generate_texts(
                    batch["text_ids"], batch["image_tensors"],
                    batch["num_image_per_seq"], batch["attention_mask"],
                    gen_cfg,
                ).cpu().numpy()[0]
                # strip padding; keep a possible trailing <soi>
                new = [int(t) for t in toks if t != self.sp.pad_token_id]
                text_part = [t for t in new if t not in stops]
                outputs["texts"].append(self.tokenizer.decode(text_part))
                ids = np.concatenate([ids, np.asarray(text_part, np.int64)])
                wants_image = ((len(new) > 0
                                and new[-1] == self.sp.soi_token_id)
                               or cfg.force_image_every_turn)
                if not (wants_image
                        and self.model.cfg.image_decoder is not None):
                    break  # nothing more to generate
                # splice in the image block and a grey placeholder
                ids = np.concatenate([ids, np.asarray(
                    [self.sp.soi_token_id] + [self.sp.image_token_id]
                    * self.ntok, np.int64)])
                images.append(self._grey_image())
                mode = "generate_images"
            else:  # generate_images: fill in the newest placeholder
                ctx, ctx_mask, mmfs_vals, mmfs_mask = (
                    self.runtime.generate_image_inputs(
                        batch["text_ids"], batch["image_tensors"],
                        batch["num_image_per_seq"], batch["attention_mask"]))
                tgt = torch.tensor([len(images) - 1], device=self.device)
                img = self.runtime.denoise(
                    ctx[tgt], ctx_mask[tgt], mmfs_vals[tgt], mmfs_mask[tgt],
                    generator, num_inference_steps=cfg.num_inference_steps,
                    guidance_scale=cfg.guidance_scale)
                arr = img[0].cpu().numpy()
                outputs["images"].append(arr)
                # re-encode the generated image as the next turns' input
                # (reference update_image, inference.py:188-196)
                pil = Image.fromarray((arr * 255).astype(np.uint8))
                images[-1] = self.transform(pil)
                mode = "generate_texts"

        outputs["text_ids"] = ids
        return outputs
