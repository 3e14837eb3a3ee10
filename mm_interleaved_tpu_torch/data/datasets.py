"""Benchmark datasets (map-style).

Re-designs of the reference `custom_datasets/` benchmark classes
(`mscoco_karpathy.py:8-97`, `caption_datasets.py:8-96`, `vqa_datasets.py:1-176`,
`lncoco.py`, `visdial_dense.py:1-128`, `vist.py:8-196`) on a shared
json-annotation base.  Each dataset yields the tuples its collator expects:

  caption/t2i: (image_or_pair, caption, sample_index)
  vqa:         (image, question, answers, sample_index)
  visdial:     dict with dialog options/ranks

The port's copy of `mm_interleaved_tpu/data/datasets.py` (the port imports
nothing of the JAX package); batches stay numpy.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np
from PIL import Image

from .loader import LocalLoader


class CocoCaptionDataset:
    """COCO-style captions.

    Accepts either a Karpathy-split json (``{"images": [{"filename"/
    "filepath"/"sentences": [...]}]}``, reference mscoco_karpathy.py) or the
    official ``captions_val2014.json`` (``{"images": [...],
    "annotations": [...]}``, reference mscoco.py:9-92).
    """

    def __init__(
        self,
        annt_file: str,
        data_root: str,
        transform: Callable,
        total_length: Optional[int] = None,
        phase: str = "test",
        loader=None,
    ):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(annt_file) as f:
            annt = json.load(f)

        self.items: List[dict] = []
        if "annotations" in annt:  # official format
            id2file = {
                im["id"]: im["file_name"] for im in annt["images"]
            }
            by_image = {}
            for a in annt["annotations"]:
                by_image.setdefault(a["image_id"], []).append(a["caption"])
            for image_id, caps in by_image.items():
                self.items.append(dict(
                    image=id2file[image_id], captions=caps,
                    image_id=image_id,
                ))
        else:  # karpathy format
            for im in annt["images"]:
                if phase and im.get("split", phase) != phase:
                    continue
                path = os.path.join(im.get("filepath", ""), im["filename"])
                self.items.append(dict(
                    image=path,
                    captions=[s["raw"] for s in im["sentences"]],
                    image_id=im.get("cocoid", im.get("imgid")),
                ))
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            os.path.join(self.data_root, item["image"])
        )
        return self.transform(img), item["captions"][0], idx

    def references(self):
        """index -> list of reference captions (for CIDEr/BLEU)."""
        return {i: item["captions"] for i, item in enumerate(self.items)}

    def image_ids(self):
        return {i: item["image_id"] for i, item in enumerate(self.items)}


class VQADataset:
    """VQAv2/OK-VQA/VizWiz-style QA (reference vqa_datasets.py:1-176).

    questions_file: {"questions": [{"image_id", "question", "question_id"}]}
    annotations_file: {"annotations": [{"question_id",
                                        "answers": [{"answer": ...}]}]}
    image_name_fn maps image_id -> relative path.
    """

    def __init__(
        self,
        questions_file: str,
        annotations_file: Optional[str],
        data_root: str,
        transform: Callable,
        image_name_fn: Optional[Callable] = None,
        image_name_format: Optional[str] = None,
        total_length: Optional[int] = None,
        loader=None,
    ):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(questions_file) as f:
            questions = json.load(f)["questions"]
        answers = {}
        if annotations_file:
            with open(annotations_file) as f:
                for a in json.load(f)["annotations"]:
                    answers[a["question_id"]] = [
                        x["answer"] for x in a["answers"]
                    ]
        if image_name_fn is None and image_name_format is not None:
            # e.g. "COCO_val2014_{:012d}.jpg" — the reference's
            # ann_name_format file naming (vqa_datasets.py:81)
            image_name_fn = image_name_format.format
        self.image_name_fn = image_name_fn or (lambda i: str(i))
        self.items = [
            dict(
                # TextVQA-style question files carry the file name directly
                # (reference vqa_datasets.py:174); VQAv2/OK-VQA derive it
                # from the numeric image_id
                image=q.get("image") or self.image_name_fn(q["image_id"]),
                question=q["question"],
                question_id=q["question_id"],
                answers=answers.get(q["question_id"], []),
            )
            for q in questions
        ]
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            os.path.join(self.data_root, item["image"])
        )
        return self.transform(img), item["question"], item["answers"], idx


class VizWizVQADataset(VQADataset):
    """VizWiz-VQA: one json list of {image, question, answers:[{answer}..]}
    (reference vqa_datasets.py:106-132). All 10 crowd answers are kept so
    the official VQA accuracy (3-of-10 consensus) applies unchanged."""

    def __init__(
        self,
        annt_file: str,
        data_root: str,
        transform: Callable,
        total_length: Optional[int] = None,
        loader=None,
    ):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(annt_file) as f:
            meta = json.load(f)
        self.image_name_fn = str
        self.items = [
            dict(
                image=ann["image"],
                question=ann["question"],
                question_id=int(
                    ann["image"].split("_")[-1].split(".")[0]
                ),
                answers=[x["answer"] for x in ann.get("answers", [])],
            )
            for ann in meta
        ]
        if total_length:
            self.items = self.items[:total_length]


class ImageTextJsonlDataset:
    """Generic (image, text) pairs from a jsonl with ``image``/``caption``
    keys — covers LN-COCO / Image2Paragraph-style sets and doubles as the
    t2i eval source."""

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, loader=None):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        self.items = []
        with open(annt_file) as f:
            for line in f:
                if line.strip():
                    self.items.append(json.loads(line))
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            os.path.join(self.data_root, item["image"])
        )
        return self.transform(img), item["caption"], idx

    def references(self):
        """index -> reference captions (single-caption jsonl rows)."""
        return {i: [item["caption"]] for i, item in enumerate(self.items)}


def iterate_dataset(dataset, batch_size: int, collator,
                    drop_last: bool = False):
    """Minimal map-style batch iterator (replaces torch DataLoader for eval)."""
    batch = []
    for i in range(len(dataset)):
        batch.append(dataset[i])
        if len(batch) == batch_size:
            yield collator(batch)
            batch = []
    if batch and not drop_last:
        yield collator(batch)
