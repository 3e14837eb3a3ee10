"""Grounding, VisDial and SFT collators.

Re-designs of the reference `custom_datasets/collator.py:724-1033`
(`GroundingCollator`, `VisDialCollator`) and `collator_sft.py:9-265`
(`MultiImageCollator`), in the padded static-shape batch layout.

The port's copy of `mm_interleaved_tpu/data/collators_extra.py` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .collators import _pad_1d, _stack_images, _image_subseq
from .tokenizer import SpecialIds


def box_to_string(box: Sequence[float]) -> str:
    """[x1,y1,x2,y2] in [0,1] -> '<box>(x1,y1)(x2,y2)</box>' with 3-digit
    coords (reference collator.py:724-990 convention, x1000)."""
    x1, y1, x2, y2 = (int(round(v * 1000)) for v in box)
    return f"<box>({x1:03d},{y1:03d})({x2:03d},{y2:03d})</box>"


@dataclasses.dataclass
class GroundingCollator:
    """Referring-expression grounding (text -> box string) and region caption
    (box -> text)."""

    tokenizer: object
    special: SpecialIds
    num_img_token: int = 64
    seq_len: int = 256
    task: str = "grounding"  # or "region_caption"

    def __call__(self, data_list):
        img_block = _image_subseq(self.num_img_token)
        texts, enc_imgs, meta = [], [], []
        for data in data_list:
            image, expr, box, index = data
            if self.task == "grounding":
                texts.append(
                    f"{img_block} Provide the bounding box of "
                    f"<ref>{expr}</ref>"
                )
                meta.append((index, expr, box))
            else:
                texts.append(
                    f"{img_block} Describe the region {box_to_string(box)}:"
                )
                meta.append((index, expr, box))
            enc_imgs.append(np.asarray(image)[None])
        rows = [self.tokenizer.encode(t, add_bos=True) for t in texts]
        length = min(self.seq_len, max(len(r) for r in rows))
        ids = np.stack([
            _pad_1d(np.asarray(r, np.int32), length,
                    self.special.pad_token_id, left=True) for r in rows
        ]).astype(np.int32)
        att = np.stack([
            _pad_1d(np.ones(len(r), np.int32), length, 0, left=True)
            for r in rows
        ]).astype(np.int32)
        imgs, counts = _stack_images(enc_imgs, 1)
        return dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, meta=meta,
        )


@dataclasses.dataclass
class VisDialCollator:
    """Visual-dialog dense ranking (reference collator.py:991-1033):
    context = image + dialog history + question; 100 answer options are
    scored by their token log-probs."""

    tokenizer: object
    special: SpecialIds
    num_img_token: int = 64
    ctx_len: int = 256
    opt_len: int = 24

    def __call__(self, data_list):
        img_block = _image_subseq(self.num_img_token)
        ctx_rows, opt_rows, rel_rows, enc_imgs, meta = [], [], [], [], []
        for data in data_list:
            image, dialog_text, options, relevance, index = data
            ctx_rows.append(self.tokenizer.encode(
                f"{img_block} {dialog_text}", add_bos=True
            ))
            opt_rows.append([self.tokenizer.encode(" " + o) for o in options])
            rel_rows.append(np.asarray(relevance, np.float32))
            enc_imgs.append(np.asarray(image)[None])
            meta.append((index,))
        L = min(self.ctx_len, max(len(r) for r in ctx_rows))
        ids = np.stack([
            _pad_1d(np.asarray(r, np.int32), L, self.special.pad_token_id,
                    left=True)
            for r in ctx_rows
        ]).astype(np.int32)
        att = np.stack([
            _pad_1d(np.ones(len(r), np.int32), L, 0, left=True)
            for r in ctx_rows
        ]).astype(np.int32)

        n_opt = max(len(o) for o in opt_rows)
        Lo = min(self.opt_len,
                 max(max(len(t) for t in o) for o in opt_rows))
        B = len(data_list)
        options_ids = np.zeros((B, n_opt, Lo), np.int32)
        options_mask = np.zeros((B, n_opt, Lo), np.int32)
        for b, opts in enumerate(opt_rows):
            for j, t in enumerate(opts):
                t = t[:Lo]
                options_ids[b, j, : len(t)] = t
                options_mask[b, j, : len(t)] = 1
        relevance = np.stack([
            _pad_1d(r, n_opt, 0.0) for r in rel_rows
        ])
        imgs, counts = _stack_images(enc_imgs, 1)
        return dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, options_ids=options_ids,
            options_mask=options_mask, relevance=relevance, meta=meta,
        )


@dataclasses.dataclass
class StoryCollator:
    """Visual storytelling eval batches (reference VISTDataset pathway +
    _inner_generation_loop_v2): the full story token stream with every frame's
    image block present; ``target_image_slots`` marks which padded image slots
    the evaluator should generate (in order), the rest are real context."""

    tokenizer: object
    special: SpecialIds
    num_img_token: int = 64
    seq_len: int = 1024
    max_num_images: int = 8
    task_prefix: str = ""

    def __call__(self, data_list):
        img_block = _image_subseq(self.num_img_token)
        rows, img_lists, targets, meta = [], [], [], []
        max_targets = 1
        for item in data_list:
            text = self.task_prefix
            for sent in item["sentences"]:
                text += " " + sent + " " + img_block
            ids = self.tokenizer.encode(text.strip(), add_bos=True)
            rows.append(ids)
            imgs = np.stack(item["images"])[: self.max_num_images]
            img_lists.append(imgs)
            tr = [t for t in item["target_rounds"]
                  if t < self.max_num_images]
            targets.append(tr)
            max_targets = max(max_targets, len(tr))
            meta.append((item.get("index", 0), item.get("story_id")))
        length = min(self.seq_len, max(len(r) for r in rows))
        ids = np.stack([
            _pad_1d(np.asarray(r, np.int32), length,
                    self.special.pad_token_id) for r in rows
        ]).astype(np.int32)
        att = np.stack([
            _pad_1d(np.ones(len(r), np.int32), length, 0) for r in rows
        ]).astype(np.int32)
        imgs, counts = _stack_images(img_lists, self.max_num_images)
        slot = np.full((len(rows), max_targets), -1, np.int32)
        for b, tr in enumerate(targets):
            slot[b, : len(tr)] = tr
        return dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, target_image_slots=slot, meta=meta,
        )


@dataclasses.dataclass
class MultiImageCollator:
    """SFT collator (reference collator_sft.py:9-265): per-sample interleaved
    conversations with multiple images, train and generate modes."""

    tokenizer: object
    special: SpecialIds
    num_img_token: int = 64
    seq_len: int = 2048
    max_num_images: int = 6
    mode: str = "train"
    # pad every batch to ``seq_len`` instead of the batch max: static
    # shapes so the jitted train step compiles once (TPU training path)
    pad_to_seq_len: bool = False

    def __call__(self, data_list):
        img_block = _image_subseq(self.num_img_token)
        rows, att_rows, img_lists, offsets, loss_masks, meta = (
            [], [], [], [], [], []
        )
        for data in data_list:
            # data: dict(images=[...], prompt=str, response=str, index=int,
            #            ignore_image_loss_idx=optional list)
            images = data["images"]
            prompt = data["prompt"].replace("<image>", img_block)
            ids = self.tokenizer.encode(prompt, add_bos=True)
            offsets.append(len(ids))
            if self.mode == "train":
                ids = ids + self.tokenizer.encode(
                    " " + data["response"], add_eos=True
                )
            rows.append(ids)
            img_lists.append(np.stack([np.asarray(im) for im in images]))
            lm = np.ones((self.max_num_images,), np.float32)
            for i in data.get("ignore_image_loss_idx", []):
                if 0 <= i < self.max_num_images:
                    lm[i] = 0.0
            loss_masks.append(lm)
            meta.append((data.get("index", 0),))
        left = self.mode != "train"
        length = (self.seq_len if self.pad_to_seq_len
                  else min(self.seq_len, max(len(r) for r in rows)))
        ids = np.stack([
            _pad_1d(np.asarray(r, np.int32), length,
                    self.special.pad_token_id, left=left) for r in rows
        ]).astype(np.int32)
        att = np.stack([
            _pad_1d(np.ones(len(r), np.int32), length, 0, left=left)
            for r in rows
        ]).astype(np.int32)
        imgs, counts = _stack_images(img_lists, self.max_num_images)
        batch = dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, meta=meta,
        )
        if self.mode == "train":
            batch["ignore_prompt_token_offset"] = np.asarray(
                offsets, np.int32
            )
            batch["image_loss_mask"] = np.stack(loss_masks)
        return batch
