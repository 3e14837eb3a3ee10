"""Batch collators — ragged host data -> static-shape device batches.

Re-design of the reference `custom_datasets/collator.py` (1,137 lines of
torch collators).  The key layout change: the reference flattens all images of
a batch into one ragged tensor; we pad to ``[B, max_num_images, ...]`` so every
jitted step sees one static shape (SURVEY.md §7.3 "ragged image batching").

Collators produce numpy dicts matching `MMInterleaved.__call__` /
`generate_*` argument names.  Generation batches are left-padded so the last
position is always real (the KV-cache prefill convention).

The port's copy of `mm_interleaved_tpu/data/collators.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .tokenizer import IMAGE_TOKEN, SOI_TOKEN, SpecialIds


def _pad_1d(arr, length, value, left=False):
    arr = np.asarray(arr)
    if len(arr) >= length:
        return arr[-length:] if left else arr[:length]
    pad = np.full((length - len(arr),), value, dtype=arr.dtype)
    return np.concatenate((pad, arr) if left else (arr, pad))


def _stack_images(image_lists: List[np.ndarray], max_img: int):
    """List of [n_i, H, W, 3] -> ([B, max_img, H, W, 3], [B] counts)."""
    B = len(image_lists)
    sample = np.asarray(image_lists[0])
    shape = sample.shape[1:]
    out = np.zeros((B, max_img, *shape), dtype=np.float32)
    counts = np.zeros((B,), dtype=np.int32)
    for i, imgs in enumerate(image_lists):
        imgs = np.asarray(imgs)[:max_img]
        out[i, : len(imgs)] = imgs
        counts[i] = len(imgs)
    return out, counts


@dataclasses.dataclass
class InterleavedTrainCollator:
    """Packed rows -> train batch (reference interleaved_collation_fn,
    collator.py:106-169)."""

    special: SpecialIds
    seq_len: int = 2048
    max_num_images: int = 10
    has_dec_images: bool = True

    def __call__(self, rows: Sequence[Dict]) -> Dict[str, np.ndarray]:
        B = len(rows)
        ids = np.stack([
            _pad_1d(r["text_ids"], self.seq_len, self.special.pad_token_id)
            for r in rows
        ]).astype(np.int32)
        att = np.stack([
            _pad_1d(r["text_attn_mask"], self.seq_len, 0) for r in rows
        ]).astype(np.int32)
        imgs, counts = _stack_images(
            [r["image_tensors"] for r in rows], self.max_num_images
        )
        batch = dict(
            text_ids=ids,
            attention_mask=att,
            image_tensors=imgs,
            num_image_per_seq=counts,
        )
        if self.has_dec_images and rows[0].get("image_tensors_dec") is not None:
            dec, _ = _stack_images(
                [r["image_tensors_dec"] for r in rows], self.max_num_images
            )
            batch["image_tensors_dec"] = dec
        return batch


def _image_subseq(num_img_token: int, add_soi: bool = True) -> str:
    s = IMAGE_TOKEN * num_img_token
    return (SOI_TOKEN + s) if add_soi else s


@dataclasses.dataclass
class ImageTextPairCollator:
    """Caption & text-to-image collator (reference collator.py:171-517).

    modes: "train", "generate_texts" (captioning), "generate_images" (t2i).
    Instruction format: ``{sys} {user} {assis}`` with ``{image}`` expanding to
    the <soi> + N x <image> block.
    """

    tokenizer: object  # HFTokenizerWrapper | SimpleWordTokenizer
    special: SpecialIds
    num_img_token: int = 64
    seq_len: int = 256
    max_num_images: int = 1
    mode: str = "generate_texts"
    text_prompt: str = "a photo of"
    instr_prompts: Optional[Dict[str, List[str]]] = None
    uncond_prob: float = 0.0  # t2i training caption dropout
    padding: str = "longest"
    # few-shot in-context examples (reference collator.py:278-317):
    # retrieved via RICES when given, else random from train_dataset
    few_shot_k: int = 0
    few_shot_template: str = "Caption: {caption}"
    train_dataset: Optional[object] = None
    rices: Optional[object] = None
    few_shot_seed: int = 0

    def __post_init__(self):
        self.instr = self.instr_prompts or {
            "image": ["", "", ""],
            "text": ["a photo of", "{image}", ""],
        }

    def _few_shot(self, query_image, rng: Optional[np.random.RandomState]):
        """(prompt_prefix, example_images) — RICES top-k when available,
        random train examples otherwise (reference collator.py:278-317)."""
        if self.few_shot_k <= 0:
            return "", []
        if self.rices is not None:
            examples = self.rices.get_examples(
                query_image[None], self.few_shot_k
            )[0]
        else:
            assert self.train_dataset is not None
            rng = rng or np.random.RandomState(self.few_shot_seed)
            idxs = rng.choice(
                len(self.train_dataset), self.few_shot_k, replace=False
            )
            examples = [self.train_dataset[int(i)] for i in idxs]
        prefix_parts, images = [], []
        block = _image_subseq(self.num_img_token)
        for ex in examples:
            enc, _, caption, _ = self._unpack(ex)
            images.append(enc)
            prefix_parts.append(
                block + " " + self.few_shot_template.format(caption=caption)
            )
        return " ".join(prefix_parts) + " ", images

    def _encode_rows(self, texts: List[str], left_pad: bool):
        rows = [
            self.tokenizer.encode(t, add_bos=True) for t in texts
        ]
        length = (
            min(self.seq_len, max(len(r) for r in rows))
            if self.padding == "longest" else self.seq_len
        )
        ids = np.stack([
            _pad_1d(np.asarray(r, np.int32), length,
                    self.special.pad_token_id, left=left_pad)
            for r in rows
        ])
        att = np.stack([
            _pad_1d(np.ones(len(r), np.int32), length, 0, left=left_pad)
            for r in rows
        ])
        return ids.astype(np.int32), att.astype(np.int32)

    def __call__(self, data_list, rng: Optional[np.random.RandomState] = None):
        if self.mode == "generate_texts":
            return self._generate_texts(data_list)
        if self.mode == "generate_images":
            return self._generate_images(data_list, rng)
        if self.mode == "train":
            return self._train(data_list, rng)
        raise NotImplementedError(self.mode)

    def _unpack(self, data):
        images_tensor, caption, index = data
        if isinstance(images_tensor, tuple):
            enc, dec = images_tensor
        else:
            enc, dec = images_tensor, None
        return enc, dec, caption, index

    def _generate_texts(self, data_list, rng=None):
        assis, user, sys = self.instr["text"]
        if "{image}" not in user:
            user = "{image}" + user
        img_block = _image_subseq(self.num_img_token)
        texts, enc_imgs, meta = [], [], []
        max_img = self.max_num_images
        for data in data_list:
            enc, dec, caption, index = self._unpack(data)
            prefix, shot_imgs = self._few_shot(enc, rng)
            texts.append(
                f"{sys} {prefix}{user.format(image=img_block)} "
                f"{assis}".strip()
            )
            enc_imgs.append(np.stack(shot_imgs + [enc]))
            max_img = max(max_img, len(shot_imgs) + 1)
            meta.append((index, caption))
        ids, att = self._encode_rows(texts, left_pad=True)
        imgs, counts = _stack_images(enc_imgs, max_img)
        return dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, meta=meta,
        )

    def _generate_images(self, data_list, rng=None):
        assis, user, sys = self.instr["image"]
        img_block = _image_subseq(self.num_img_token)
        texts, enc_imgs, dec_imgs, meta = [], [], [], []
        for data in data_list:
            enc, dec, caption, index = self._unpack(data)
            texts.append(
                f"{sys} {user} {caption} {assis} {img_block}".strip()
            )
            enc_imgs.append(enc[None])
            if dec is not None:
                dec_imgs.append(dec[None])
            meta.append((index, caption))
        ids, att = self._encode_rows(texts, left_pad=False)
        imgs, counts = _stack_images(enc_imgs, self.max_num_images)
        batch = dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, meta=meta,
        )
        if dec_imgs:
            batch["image_tensors_dec"], _ = _stack_images(
                dec_imgs, self.max_num_images
            )
        return batch

    def _train(self, data_list, rng=None):
        assis, user, sys = self.instr["text"]
        if "{image}" not in user:
            user = "{image}" + user
        img_block = _image_subseq(self.num_img_token)
        texts, enc_imgs, dec_imgs, offsets = [], [], [], []
        for data in data_list:
            enc, dec, caption, index = self._unpack(data)
            if self.uncond_prob > 0 and rng is not None and (
                rng.rand() < self.uncond_prob
            ):
                caption = ""
            prompt = f"{sys} {user.format(image=img_block)} {assis}".strip()
            offsets.append(len(self.tokenizer.encode(prompt, add_bos=True)))
            texts.append(prompt + " " + caption)
            enc_imgs.append(enc[None])
            if dec is not None:
                dec_imgs.append(dec[None])
        ids, att = self._encode_rows(texts, left_pad=False)
        imgs, counts = _stack_images(enc_imgs, self.max_num_images)
        batch = dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts,
            ignore_prompt_token_offset=np.asarray(offsets, np.int32),
        )
        if dec_imgs:
            batch["image_tensors_dec"], _ = _stack_images(
                dec_imgs, self.max_num_images
            )
        return batch


@dataclasses.dataclass
class VQACollator:
    """VQA eval collator (reference collator.py:519-723), with few-shot
    in-context examples (``{few_shot_example}`` placeholder semantics and
    the reference default template ``"Question: {question} Short answer:
    {answer}{eos_token}"``, collator.py:63-67, 617-633): exemplar images
    come first, then the query image."""

    tokenizer: object
    special: SpecialIds
    num_img_token: int = 64
    seq_len: int = 320
    instr_prompts: Optional[List[str]] = None
    few_shot_k: int = 0
    few_shot_template: str = (
        "Question: {question} Short answer: {answer}{eos_token}"
    )
    train_dataset: Optional[object] = None
    rices: Optional[object] = None
    few_shot_seed: int = 0

    def __post_init__(self):
        self.instr = self.instr_prompts or [
            "The answer is:",
            "Based on the image, please answer the question. {image}"
            "{question} Please provide an accurate answer within one word.",
            "",
        ]

    def _few_shot(self, query_image, rng):
        """(example_string, example_images) — RICES top-k or random train
        samples (reference get_few_shot_samples, collator.py:681-723)."""
        if self.few_shot_k <= 0:
            return "", []
        if self.rices is not None:
            examples = self.rices.get_examples(
                query_image[None], self.few_shot_k
            )[0]
        else:
            assert self.train_dataset is not None
            rng = rng or np.random.RandomState(self.few_shot_seed)
            idxs = rng.choice(
                len(self.train_dataset), self.few_shot_k, replace=False
            )
            examples = [self.train_dataset[int(i)] for i in idxs]
        img_block = _image_subseq(self.num_img_token)
        with_image = "{image}" in self.few_shot_template
        eos = getattr(self.tokenizer, "eos_token", "") or ""
        parts, images = [], []
        for ex in examples:
            img, question, answers = ex[0], ex[1], ex[2]
            answer = answers[0] if isinstance(answers, (list, tuple)) \
                else answers
            fields = dict(question=question, answer=answer, eos_token=eos)
            if with_image:
                fields["image"] = img_block
                images.append(img[0] if isinstance(img, tuple) else img)
            parts.append(self.few_shot_template.format(**fields))
        return "".join(parts), images

    def __call__(self, data_list, rng: Optional[np.random.RandomState] = None):
        assis, user, sys = self.instr
        img_block = _image_subseq(self.num_img_token)
        texts, enc_imgs, meta = [], [], []
        for data in data_list:
            images_tensor, question, answer, index = data
            enc = (images_tensor[0] if isinstance(images_tensor, tuple)
                   else images_tensor)
            shot_text, shot_imgs = self._few_shot(enc, rng)
            fields = dict(image=img_block, question=question)
            if "{few_shot_example}" in user:
                fields["few_shot_example"] = shot_text
                body = user.format(**fields)
            else:
                body = shot_text + user.format(**fields)
            texts.append(f"{sys} {body} {assis}".strip())
            enc_imgs.append(np.stack(
                [np.asarray(im) for im in shot_imgs] + [np.asarray(enc)]
            ))
            meta.append((index, question, answer))
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
        imgs, counts = _stack_images(enc_imgs, 1 + max(0, self.few_shot_k))
        return dict(
            text_ids=ids, attention_mask=att, image_tensors=imgs,
            num_image_per_seq=counts, meta=meta,
        )
