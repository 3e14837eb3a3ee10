"""Benchmark datasets: dialog, storytelling, grounding, SFT.

Re-designs of the reference classes: `visdial_dense.py:1-128`
(VisDialDenseDataset), `vist.py:8-196` (VISTDataset), `pororo.py` /
`flintstones.py` (story sets), `grounding_datasets.py:1-565`
(RefCOCO-style), `sft_datasets.py:1-97` (LLaVADataset +
WeightedConcatDataset), `ade20k.py:9-225` (segmentation-to-image).

The port's copy of `mm_interleaved_tpu/data/datasets_extra.py` (the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

import numpy as np

from .loader import LocalLoader


class VisDialDenseDataset:
    """VisDial v1.0 val with dense relevance annotations.

    dialogs_file: the official visdial_1.0_val.json;
    dense_file: visdial_1.0_val_dense_annotations.json.
    Yields (image, dialog_text, options, relevance, index) for the round
    carrying dense annotations (reference visdial_dense.py:1-128).
    """

    def __init__(self, dialogs_file: str, dense_file: str, data_root: str,
                 transform: Callable, total_length: Optional[int] = None,
                 loader=None):
        self.transform = transform
        self.data_root = data_root
        self.loader = loader or LocalLoader()
        with open(dialogs_file) as f:
            data = json.load(f)["data"]
        with open(dense_file) as f:
            dense = json.load(f)
        self.questions = data["questions"]
        self.answers = data["answers"]
        dialogs = {d["image_id"]: d for d in data["dialogs"]}
        self.items = []
        for ann in dense:
            d = dialogs.get(ann["image_id"])
            if d is None:
                continue
            self.items.append(dict(
                image_id=ann["image_id"],
                caption=d["caption"],
                dialog=d["dialog"],
                round_id=ann["round_id"],
                relevance=ann["gt_relevance"],
            ))
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(os.path.join(
            self.data_root, f"VisualDialog_val2018_{item['image_id']:012d}.jpg"
        ))
        r = item["round_id"] - 1
        history = [item["caption"]]
        for turn in item["dialog"][:r]:
            history.append(self.questions[turn["question"]] + "?")
            history.append(self.answers[turn["answer"]])
        question = self.questions[item["dialog"][r]["question"]] + "?"
        dialog_text = " ".join(history + [question])
        options = [self.answers[a] for a in item["dialog"][r]
                   ["answer_options"]]
        return (self.transform(img), dialog_text, options,
                item["relevance"], idx)


class StoryDataset:
    """Visual storytelling (VIST / Pororo / FlintStones shape,
    reference vist.py:8-196): a sequence of (sentence, image) frames; the
    model generates each target frame conditioned on the story so far.

    annt jsonl rows: {"story_id", "sentences": [...], "images": [paths...],
    "target_rounds": [frame indices to generate]}.
    """

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 task_prefix: str = "", total_length: Optional[int] = None,
                 loader=None):
        self.transform = transform
        self.data_root = data_root
        self.task_prefix = task_prefix
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
        images = [
            self.transform(self.loader.load_image(
                os.path.join(self.data_root, p)
            ))
            for p in item["images"]
        ]
        return dict(
            sentences=item["sentences"],
            images=images,
            target_rounds=item.get(
                "target_rounds", [len(images) - 1]
            ),
            index=idx,
            story_id=item.get("story_id", idx),
        )


class GroundingDataset:
    """RefCOCO/+/g-style referring expressions
    (reference grounding_datasets.py:1-565).

    annt jsonl rows: {"image", "expression", "bbox": [x1,y1,x2,y2] in
    pixels, "width", "height"}. Boxes normalise to [0,1].
    """

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, loader=None):
        self.transform = transform
        self.data_root = data_root
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
        w = item.get("width", img.size[0])
        h = item.get("height", img.size[1])
        x1, y1, x2, y2 = item["bbox"]
        box = [x1 / w, y1 / h, x2 / w, y2 / h]
        return self.transform(img), item["expression"], box, idx


class LLaVADataset:
    """LLaVA-style SFT conversations (reference sft_datasets.py:1-97).

    annt json: [{"image": path or [paths], "conversations":
    [{"from": "human"/"gpt", "value": ...}]}] with "<image>" markers.
    Yields MultiImageCollator-ready dicts.
    """

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, loader=None):
        self.transform = transform
        self.data_root = data_root
        self.loader = loader or LocalLoader()
        with open(annt_file) as f:
            self.items = json.load(f)
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        paths = item.get("image", [])
        if isinstance(paths, str):
            paths = [paths]
        images = [
            self.transform(self.loader.load_image(
                os.path.join(self.data_root, p)
            ))
            for p in paths
        ]
        prompt_parts, response = [], ""
        for turn in item["conversations"]:
            if turn["from"] == "human":
                prompt_parts.append(turn["value"])
            else:
                response = turn["value"]
        return dict(
            images=images,
            prompt=" ".join(prompt_parts),
            response=response,
            index=idx,
        )


class WeightedConcatDataset:
    """Probability-weighted concat of map-style datasets
    (reference sft_datasets.py WeightedConcatDataset)."""

    def __init__(self, datasets: List, weights: Optional[List[float]] = None,
                 seed: int = 0, length: Optional[int] = None):
        self.datasets = datasets
        w = np.asarray(weights or [1.0] * len(datasets), np.float64)
        self.probs = w / w.sum()
        self.length = length or sum(len(d) for d in datasets)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.RandomState((idx * 2654435761) % (2 ** 31))
        di = int(rng.choice(len(self.datasets), p=self.probs))
        ds = self.datasets[di]
        return ds[int(rng.randint(len(ds)))]


# ADE20k palette-based segmentation-to-image (reference ade20k.py:9-225,
# segm_eval.py:9-70): segmentation maps render to palette colours; generated
# images map back to the nearest palette class for mIoU.

def ade20k_palette(num_classes: int = 150) -> np.ndarray:
    """The official ADE20k colour palette (reference ade20k.py:178-204):
    first ``num_classes`` class colours, skipping the row-0 unlabeled
    entry. [num_classes, 3] uint8."""
    from .datasets_bench import ade20k_official_palette

    return ade20k_official_palette()[1 : num_classes + 1]


def segm_to_rgb(segm: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """[H, W] class ids -> [H, W, 3] float in [0,1]."""
    return palette[np.clip(segm, 0, len(palette) - 1)].astype(np.float32) / 255.0


def rgb_to_segm(image: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Nearest-palette-colour class map (segm_eval.py colour matching)."""
    img = (np.asarray(image, np.float32) * 255.0).reshape(-1, 1, 3)
    pal = palette.astype(np.float32)[None]  # [1, C, 3]
    d = np.square(img - pal).sum(-1)  # [HW, C]
    return d.argmin(-1).reshape(image.shape[:2])
