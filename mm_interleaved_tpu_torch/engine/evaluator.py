"""Evaluation harness: per-dataset routes and their metrics (counterpart of
`mm_interleaved_tpu/engine/evaluator.py`).

Each eval dataset declares a ``collate_mode`` that routes to a loop:

  * ``generate_texts``  -> caption decode -> CIDEr / BLEU-4 / ROUGE-L / METEOR
  * ``generate_vqa``    -> short-answer decode -> VQA accuracy
  * ``generate_images`` -> SD sampling -> images saved, FID with a feature fn
  * grounding (box strings, acc@IoU 0.5), ranking (option scores, NDCG),
    storytelling (frames generated in turn, each re-encoded as context)
    and segmentation to image (the photo from a colour-rendered map, mIoU
    with a segmenter)

Batches arrive numpy from the collators and go to the device as the
runtime takes them.  Results append to ``eval_metrics.jsonl``.

Differences from the JAX harness: draws come from `torch.Generator`s (a
t2i candidate's seeded from its (batch, candidate), a storytelling
round's from its (batch, round), a segmentation-to-image batch's from its
batch index) in place of ``fold_in`` / ``split``; `gather_predictions` is
the identity in one process and refuses a larger `torch.distributed` world
(multi-GPU, ROADMAP.md §1 item 6).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..generation.text import TextGenerationConfig
from ..parallel.inference import LocalGenerator
from ..utils import fid as F
from ..utils import metrics as M
from ..utils.device import to_device
from ..utils.logging import rank


@dataclasses.dataclass
class EvalConfig:
    batch_size: int = 8
    max_new_tokens: int = 30
    min_new_tokens: int = 8
    # reference generate_texts defaults num_beams=5 (mm_interleaved.py:612);
    # 1 = greedy for fast smoke runs
    num_beams: int = 1
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    top_p: float = 0.9
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    # 8-candidate CLIP rerank in the release t2i protocol
    # (mm_eval.yaml:145 num_validation_images)
    num_candidates: int = 1
    output_dir: Optional[str] = None
    max_batches: Optional[int] = None


def seeded_generator(device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``keys``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(keys)).generate_state(1)[0]))
    return g


class Evaluator:
    def __init__(self, model, tokenizer, cfg: EvalConfig, runtime=None):
        self.model = model
        self.tokenizer = tokenizer
        self.cfg = cfg
        # every generation call goes through the runtime seam
        self.runtime = runtime or LocalGenerator(model)
        self.device = next(model.parameters()).device

    def _batches(self, batches):
        """``batches`` on the device, at most ``max_batches`` of them."""
        for bi, batch in enumerate(batches):
            if self.cfg.max_batches and bi >= self.cfg.max_batches:
                return
            yield bi, to_device(batch, self.device)

    # ------------------------------------------------------------------ #

    def _gen_cfg(self, **overrides) -> TextGenerationConfig:
        sp = self.model.cfg.special
        base = dict(
            max_new_tokens=self.cfg.max_new_tokens,
            # never let a small max_new_tokens invert the min/max ordering
            min_new_tokens=min(self.cfg.min_new_tokens,
                               self.cfg.max_new_tokens),
            num_beams=self.cfg.num_beams,
            repetition_penalty=self.cfg.repetition_penalty,
            length_penalty=self.cfg.length_penalty,
            top_p=self.cfg.top_p,
            eos_token_ids=(sp.eos_token_id, sp.soi_token_id),
            pad_token_id=sp.pad_token_id,
        )
        base.update(overrides)
        return TextGenerationConfig(**base)

    def _decode_batch(self, batch, gen_cfg) -> List[str]:
        tokens = self.runtime.generate_texts(
            batch["text_ids"], batch["image_tensors"],
            batch["num_image_per_seq"], batch["attention_mask"],
            gen_cfg,
        )
        sp = self.model.cfg.special
        out = []
        for row in tokens.cpu().numpy():
            row = [int(t) for t in row
                   if t not in (sp.pad_token_id, sp.eos_token_id,
                                sp.soi_token_id)]
            out.append(self.tokenizer.decode(row))
        return out

    # ------------------------------------------------------------------ #

    def evaluate_caption(self, batches, references: Dict[int, List[str]],
                         dataset_name: str = "caption") -> Dict[str, float]:
        preds: Dict[int, str] = {}
        gen_cfg = self._gen_cfg()
        for _, batch in self._batches(batches):
            texts = self._decode_batch(batch, gen_cfg)
            # meta is (index, caption), or (index,) from the
            # MultiImageCollator of VIST's captioning route
            for meta, text in zip(batch["meta"], texts):
                preds[meta[0]] = text
        idxs = sorted(preds.keys())
        cands = [preds[i] for i in idxs]
        refs = [references[i] for i in idxs]
        result = {
            "CIDEr": M.cider_d(cands, refs),
            "BLEU4": M.bleu(cands, refs),
            "ROUGE_L": M.rouge_l(cands, refs),
            "METEOR": M.meteor(cands, refs),
            "num_samples": len(cands),
        }
        self._sink(dataset_name, result)
        return result

    def evaluate_vqa(self, batches, dataset_name: str = "vqa"
                     ) -> Dict[str, float]:
        accs = []
        # the per-task defaults (VQACollator max_length=10 min_length=0
        # num_beams=3) come from `evaluate.resolve_eval_config`
        gen_cfg = self._gen_cfg(min_new_tokens=0)
        for _, batch in self._batches(batches):
            texts = self._decode_batch(batch, gen_cfg)
            for (index, _q, answers), text in zip(batch["meta"], texts):
                if not answers:
                    continue
                accs.append(
                    M.vqa_accuracy(M.extract_vqa_answer(text), answers)
                )
        result = {
            "vqa_accuracy": float(np.mean(accs)) if accs else 0.0,
            "num_samples": len(accs),
        }
        self._sink(dataset_name, result)
        return result

    def _out_dir(self, dataset_name: str, save: bool = True):
        if not (save and self.cfg.output_dir):
            return None
        out_dir = os.path.join(self.cfg.output_dir, dataset_name)
        os.makedirs(out_dir, exist_ok=True)
        return out_dir

    def _denoise(self, inputs, rows, generator):
        ctx, ctx_mask, mmfs_vals, mmfs_mask = inputs
        rows = torch.as_tensor(rows, device=ctx.device)
        return self.runtime.denoise(
            ctx[rows], ctx_mask[rows], mmfs_vals[rows], mmfs_mask[rows],
            generator, num_inference_steps=self.cfg.num_inference_steps,
            guidance_scale=self.cfg.guidance_scale,
        ).cpu().numpy()

    def evaluate_t2i(self, batches, dataset_name: str = "t2i",
                     save_images: bool = True,
                     num_candidates: Optional[int] = None,
                     rerank_fn=None, feature_fn=None) -> Dict[str, float]:
        """Generate images; with ``feature_fn(images [N,H,W,3] in [0,1]) ->
        [N,D]``, FID against the ground-truth images.  With ``num_candidates
        > 1`` and ``rerank_fn(images, captions) -> best_idx_per_caption``,
        the best of the candidates (the 8-candidate CLIP rerank,
        `utils.fid.make_clip_rerank_fn`); candidate 0 otherwise."""
        if num_candidates is None:
            num_candidates = self.cfg.num_candidates
        n = 0
        out_dir = self._out_dir(dataset_name, save_images)
        gen_arrays, gt_arrays = [], []
        for bi, batch in self._batches(batches):
            inputs = self.runtime.generate_image_inputs(
                batch["text_ids"], batch["image_tensors"],
                batch["num_image_per_seq"], batch["attention_mask"],
            )
            B = batch["text_ids"].shape[0]
            max_img = batch["image_tensors"].shape[1]
            # targets are the last image slot of each row
            tgt = (np.arange(B) * max_img
                   + batch["num_image_per_seq"].cpu().numpy() - 1)
            cands = [self._denoise(inputs, tgt,
                                   seeded_generator(self.device, bi, c))
                     for c in range(num_candidates)]
            if num_candidates > 1 and rerank_fn is not None:
                captions = [m[1] for m in batch["meta"]]
                stacked = np.concatenate(cands, axis=0)  # [C*B, H, W, 3]
                best = rerank_fn(stacked, captions)  # [B] candidate idx
                picked = np.stack([cands[best[i]][i] for i in range(B)])
            else:
                picked = cands[0]
            arr = (picked * 255).astype(np.uint8)
            if feature_fn is not None:
                gen_arrays.append(picked)
                gt = batch.get("image_tensors_dec", batch["image_tensors"])
                gt = gt.reshape((-1,) + tuple(gt.shape[2:]))
                gt_arrays.append(gt[torch.as_tensor(tgt, device=gt.device)]
                                 .cpu().numpy())
            if out_dir is not None:
                from PIL import Image

                for (index, _), im in zip(batch["meta"], arr):
                    Image.fromarray(im).save(
                        os.path.join(out_dir, f"{index}.png"))
            n += arr.shape[0]
        result = {"num_generated": n, "image_dir": out_dir or ""}
        if feature_fn is not None and gen_arrays:
            fake = feature_fn(np.concatenate(gen_arrays, axis=0))
            real = feature_fn(np.concatenate(gt_arrays, axis=0))
            result["fid"] = F.fid_from_features(real, fake)
        self._sink(dataset_name, result)
        return result

    def evaluate_segm2img(self, batches, gt_segm_by_index: Dict[int,
                          np.ndarray], segment_fn=None,
                          dataset_name: str = "ade20k",
                          num_classes: int = 150) -> Dict[str, float]:
        """Segmentation-to-image eval (reference generate_segm route,
        lmm_trainer.py:1450-1489 + 1534-1556): generate the photo from the
        colour-rendered segm map + caption, run a semantic segmenter over
        the generated photo (``segment_fn(image [H,W,3] in [0,1]) -> [H,W]
        1-indexed class map``, the OneFormer analogue of
        segm_eval.py:9-22), then accumulate the official
        intersection-and-union mIoU against the ground-truth class maps.

        Without ``segment_fn``, images are generated and saved and only
        ``num_generated`` is reported (the reference likewise skips the
        metric off the main process)."""
        from PIL import Image

        out_dir = self._out_dir(dataset_name)
        preds, labels = [], []
        n = 0
        for bi, batch in self._batches(batches):
            inputs = self.runtime.generate_image_inputs(
                batch["text_ids"], batch["image_tensors"],
                batch["num_image_per_seq"], batch["attention_mask"],
            )
            B = batch["text_ids"].shape[0]
            max_img = batch["image_tensors"].shape[1]
            slot = batch["target_image_slots"][:, 0].cpu().numpy()
            tgt = np.arange(B) * max_img + np.maximum(slot, 0)
            imgs = self._denoise(inputs, tgt,
                                 seeded_generator(self.device, bi))
            for b, (index, _sid) in enumerate(batch["meta"]):
                if out_dir is not None:
                    Image.fromarray((imgs[b] * 255).astype(np.uint8)).save(
                        os.path.join(out_dir, f"{index:06d}.png"))
                n += 1
                if segment_fn is None:
                    continue
                gt = np.asarray(gt_segm_by_index[index])
                pred = np.asarray(segment_fn(imgs[b]))
                if pred.shape != gt.shape:
                    pred = np.asarray(Image.fromarray(
                        pred.astype(np.uint8)
                    ).resize(gt.shape[::-1], Image.NEAREST))
                preds.append(pred)
                labels.append(gt)
        result: Dict[str, float] = {"num_generated": n}
        if preds:
            result["miou"] = M.miou_from_maps(preds, labels, num_classes)
        self._sink(dataset_name, result)
        return result

    def evaluate_grounding(self, batches, dataset_name: str = "grounding"
                           ) -> Dict[str, float]:
        """Referring-expression grounding: decode '<box>(x,y)(x,y)</box>'
        strings, score acc@IoU0.5 (reference lmm_trainer.py:1580-1592)."""
        gen_cfg = self._gen_cfg(min_new_tokens=1, max_new_tokens=24)
        preds, gts = [], []
        for _, batch in self._batches(batches):
            texts = self._decode_batch(batch, gen_cfg)
            for (index, expr, gt_box), text in zip(batch["meta"], texts):
                boxes = M.parse_box_string(text)
                preds.append(boxes[0] if boxes else [0.0, 0.0, 0.0, 0.0])
                gts.append(gt_box)
        result = {
            "grounding_acc@0.5": M.grounding_accuracy(preds, gts),
            "num_samples": len(preds),
        }
        self._sink(dataset_name, result)
        return result

    def evaluate_ranking(self, batches, dataset_name: str = "visdial"
                         ) -> Dict[str, float]:
        """Option-ranking eval -> NDCG (reference _inner_ranking_loop,
        lmm_trainer.py:1812-1912)."""
        all_scores, all_rel = [], []
        for _, batch in self._batches(batches):
            scores = self.runtime.generate_scores(
                batch["text_ids"], batch["options_ids"],
                batch["options_mask"], batch["image_tensors"],
                batch["num_image_per_seq"], batch["attention_mask"],
            )
            all_scores.append(scores)
            all_rel.append(batch["relevance"].cpu().numpy())
        scores = np.concatenate(all_scores)
        rel = np.concatenate(all_rel)
        result = {"ndcg": M.ndcg(scores, rel), "num_samples": len(scores)}
        self._sink(dataset_name, result)
        return result

    def evaluate_storytelling(self, batches, dataset_name: str = "vist",
                              feature_fn=None) -> Dict[str, float]:
        """Image-sequence generation: each generated frame is re-encoded as
        context for the next (reference _inner_generation_loop_v2,
        lmm_trainer.py:1605-1810).  Batches carry ``target_image_slots``
        [B, n_targets] (indices into the padded image axis, -1 = none);
        frames generate in slot order.  With ``feature_fn``, FID and the
        CLIP image-image similarity between generated and ground-truth
        frames."""
        from PIL import Image as PILImage

        out_dir = self._out_dir(dataset_name)
        n = 0
        gen_arrays, gt_arrays = [], []
        enc_res = self.model.cfg.visual.encoder.vit.image_size
        for bi, batch in self._batches(batches):
            original = batch["image_tensors"].cpu().numpy()
            image_tensors = batch["image_tensors"].clone()
            targets = batch["target_image_slots"].cpu().numpy()
            B = image_tensors.shape[0]
            max_img = image_tensors.shape[1]
            for r in range(targets.shape[1]):
                slot = targets[:, r]
                if (slot < 0).all():
                    continue
                inputs = self.runtime.generate_image_inputs(
                    batch["text_ids"], image_tensors,
                    batch["num_image_per_seq"], batch["attention_mask"],
                )
                flat = np.arange(B) * max_img + np.maximum(slot, 0)
                arr = self._denoise(inputs, flat,
                                    seeded_generator(self.device, bi, r))
                # feed generated frames back as encoder inputs
                # (reference lmm_trainer.py:1683-1703)
                resized = np.stack([
                    np.asarray(PILImage.fromarray(
                        (a * 255).astype(np.uint8)
                    ).resize((enc_res, enc_res)), np.float32) / 255.0
                    for a in arr
                ])
                for b in range(B):
                    if slot[b] < 0:
                        continue
                    if feature_fn is not None:
                        gen_arrays.append(arr[b])
                        # the ground-truth frame (the slot before any
                        # overwrite) at the generated resolution
                        gt = np.asarray(PILImage.fromarray(
                            (original[b, slot[b]] * 255).astype(np.uint8)
                        ).resize(arr.shape[1:3][::-1]), np.float32) / 255.0
                        gt_arrays.append(gt)
                    image_tensors[b, slot[b]] = torch.from_numpy(resized[b])
                    if out_dir is not None:
                        idx = batch["meta"][b][0]
                        PILImage.fromarray(
                            (arr[b] * 255).astype(np.uint8)
                        ).save(os.path.join(out_dir, f"{idx}_round{r}.png"))
                        n += 1
        result = {"num_generated": n, "image_dir": out_dir or ""}
        if feature_fn is not None and gen_arrays:
            fake_feats = feature_fn(np.stack(gen_arrays))
            real_feats = feature_fn(np.stack(gt_arrays))
            result["fid"] = F.fid_from_features(real_feats, fake_feats)
            result["clip_sim_i2i"] = float(
                F.clip_similarity(fake_feats, real_feats).mean()
            )
        self._sink(dataset_name, result)
        return result

    # ------------------------------------------------------------------ #

    @staticmethod
    def gather_predictions(local: Dict) -> Dict:
        """The predictions of every process: the identity in one process.
        A larger `torch.distributed` world is refused (the JAX harness
        all-gathers across hosts; multi-GPU is ROADMAP.md §1 item 6)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "gather_predictions across processes is not ported yet "
                "(ROADMAP.md §1 item 6)")
        return local

    def _sink(self, dataset_name: str, result: Dict):
        """Append to eval_metrics.jsonl (reference lmm_trainer.py:2165-2177)."""
        if not self.cfg.output_dir or rank() != 0:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(
            os.path.join(self.cfg.output_dir, "eval_metrics.jsonl"), "a"
        ) as f:
            f.write(json.dumps(
                {"dataset": dataset_name, "time": time.time(), **result}
            ) + "\n")
