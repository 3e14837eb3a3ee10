"""Remaining benchmark dataset classes of the reference eval matrix.

Re-designs (same annotation formats, our collator conventions) of:

  * NoCaps / Flickr30K        — reference custom_datasets/caption_datasets.py:8-96
  * Image2Paragraph           — image2paragraph.py
  * LN-COCO                   — lncoco.py
  * ADE20k (segm-to-image)    — ade20k.py:9-225
  * Pororo storytelling       — pororo.py:10-265
  * FlintStones storytelling  — flintstones.py:11-257
  * VIST proper               — vist.py:8-196
  * RegionCaption / GroundedCaption / IterableKosmos2 — grounding_datasets.py
  * CLIP image-text / image-pair sets (RICES + CLIP-i2i) — clip_itp.py:1-93

Output conventions (matching the round-1 collators):

  caption sets   -> (image, caption, idx) tuples + ``references()``
  t2i sets       -> (image_or_pair, caption, idx) + ``image_id_to_path``
  story sets     -> StoryCollator dicts (sentences / images / target_rounds)
  VIST captions  -> MultiImageCollator dicts (images / prompt / response)
  grounding sets -> (image, expression, box01, idx) for GroundingCollator

The port's copy of `mm_interleaved_tpu/data/datasets_bench.py` (the port
imports nothing of the JAX package).  One change: `IterableKosmos2Dataset`
stripes its lines by the `torch.distributed` rank where the JAX one reads
``jax.process_index()``.
"""

from __future__ import annotations

import json
import os
import pickle
from functools import cached_property
from typing import Callable, List, Optional

import numpy as np
from PIL import Image

from .loader import LocalLoader


# --------------------------------------------------------------------- #
# caption benchmarks                                                     #
# --------------------------------------------------------------------- #

class NoCapsDataset:
    """Official nocaps json: {"images": [{"id", "file_name"}],
    "annotations": [{"image_id", "caption"}]} (caption_datasets.py:33-54).
    Evaluation runs image-deduplicated with all captions as references."""

    name = "nocaps"

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, image_only: bool = True,
                 loader=None):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(annt_file) as f:
            meta = json.load(f)
        file_by_id = {im["id"]: im["file_name"] for im in meta["images"]}
        caps_by_id = {}
        for ann in meta["annotations"]:
            caps_by_id.setdefault(ann["image_id"], []).append(ann["caption"])
        self.items = [
            dict(image=file_by_id[i], captions=caps, image_id=i)
            for i, caps in caps_by_id.items()
        ]
        if not image_only:
            self.items = [
                dict(image=it["image"], captions=[c], image_id=it["image_id"])
                for it in self.items for c in it["captions"]
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
        return self.transform(img), item["captions"][0].lower(), idx

    def references(self):
        return {i: it["captions"] for i, it in enumerate(self.items)}

    def image_ids(self):
        return {i: it["image_id"] for i, it in enumerate(self.items)}


class Flickr30KDataset(NoCapsDataset):
    """Same coco-format annotation file (test1k.token.coco_format,
    mm_eval.yaml:66-76)."""

    name = "flickr30k"


class Image2ParagraphDataset:
    """Stanford image-paragraph captions (image2paragraph.py): annotations/
    paragraphs_coco.json + {phase}_split.json; image path from the last two
    url components."""

    name = "image2paragraph"

    def __init__(self, annt_root: str, data_root: str, transform: Callable,
                 phase: str = "test", total_length: Optional[int] = None,
                 loader=None):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(os.path.join(
            annt_root, "annotations", "paragraphs_coco.json"
        )) as f:
            data = json.load(f)
        annts = {d["image_id"]: d for d in data["annotations"]}
        with open(os.path.join(
            annt_root, "annotations", f"{phase}_split.json"
        )) as f:
            split = set(json.load(f))
        self.items = [v for k, v in annts.items() if k in split]
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def _path(self, item):
        return os.path.join(self.data_root, *item["url"].split("/")[-2:])

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(self._path(item))
        return self.transform(img), item["caption"], idx

    def references(self):
        return {i: [it["caption"]] for i, it in enumerate(self.items)}


# --------------------------------------------------------------------- #
# text-to-image benchmarks                                               #
# --------------------------------------------------------------------- #

class LNCOCODataset:
    """Localized Narratives COCO-val (lncoco.py): coco_val_captions.jsonl
    rows {"image_id", "caption"}; images under val2017/. ``total_length``
    larger than the file oversamples inversely to per-image caption counts
    (lncoco.py:38-47)."""

    name = "lncoco"

    def __init__(self, annt_root: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, image_only: bool = False,
                 seed: int = 0, loader=None):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(os.path.join(annt_root, "coco_val_captions.jsonl")) as f:
            self.items = [json.loads(s) for s in f if s.strip()]
        if image_only:
            seen, dedup = set(), []
            for it in self.items:
                if it["image_id"] in seen:
                    continue
                seen.add(it["image_id"])
                dedup.append(it)
            self.items = dedup
        if total_length is not None:
            if total_length <= len(self.items):
                self.items = self.items[:total_length]
            else:
                from collections import Counter

                cnt = Counter(it["image_id"] for it in self.items)
                w = np.asarray(
                    [1.0 / cnt[it["image_id"]] for it in self.items]
                )
                w = w / w.sum()
                rng = np.random.RandomState(seed)
                extra = rng.choice(
                    len(self.items), total_length - len(self.items), p=w
                )
                self.items = self.items + [self.items[i] for i in extra]

    def __len__(self):
        return len(self.items)

    def image_id_to_path(self, image_id: int) -> str:
        return os.path.join(self.data_root, "val2017",
                            f"{int(image_id):012d}.jpg")

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            self.image_id_to_path(item["image_id"])
        )
        return self.transform(img), item["caption"], idx

    def image_ids(self):
        return {i: it["image_id"] for i, it in enumerate(self.items)}


# --------------------------------------------------------------------- #
# ADE20k segmentation-to-image                                           #
# --------------------------------------------------------------------- #

# Official ADE20k colour palette (ade20k.py:178-204 `palette`): 151 * 3
# flattened RGB values, index 0 = unlabeled. A necessarily-identical
# constant table, like the CLIP mean/std.
ADE20K_PALETTE_FLAT = [
    0, 0, 0, 120, 120, 120, 180, 120, 120, 6, 230, 230, 80, 50, 50, 4, 200,
    3, 120, 120, 80, 140, 140, 140, 204, 5, 255, 230, 230, 230, 4, 250, 7,
    224, 5, 255, 235, 255, 7, 150, 5, 61, 120, 120, 70, 8, 255, 51, 255, 6,
    82, 143, 255, 140, 204, 255, 4, 255, 51, 7, 204, 70, 3, 0, 102, 200, 61,
    230, 250, 255, 6, 51, 11, 102, 255, 255, 7, 71, 255, 9, 224, 9, 7, 230,
    220, 220, 220, 255, 9, 92, 112, 9, 255, 8, 255, 214, 7, 255, 224, 255,
    184, 6, 10, 255, 71, 255, 41, 10, 7, 255, 255, 224, 255, 8, 102, 8, 255,
    255, 61, 6, 255, 194, 7, 255, 122, 8, 0, 255, 20, 255, 8, 41, 255, 5,
    153, 6, 51, 255, 235, 12, 255, 160, 150, 20, 0, 163, 255, 140, 140, 140,
    250, 10, 15, 20, 255, 0, 31, 255, 0, 255, 31, 0, 255, 224, 0, 153, 255,
    0, 0, 0, 255, 255, 71, 0, 0, 235, 255, 0, 173, 255, 31, 0, 255, 11, 200,
    200, 255, 82, 0, 0, 255, 245, 0, 61, 255, 0, 255, 112, 0, 255, 133, 255,
    0, 0, 255, 163, 0, 255, 102, 0, 194, 255, 0, 0, 143, 255, 51, 255, 0, 0,
    82, 255, 0, 255, 41, 0, 255, 173, 10, 0, 255, 173, 255, 0, 0, 255, 153,
    255, 92, 0, 255, 0, 255, 255, 0, 245, 255, 0, 102, 255, 173, 0, 255, 0,
    20, 255, 184, 184, 0, 31, 255, 0, 255, 61, 0, 71, 255, 255, 0, 204, 0,
    255, 194, 0, 255, 82, 0, 10, 255, 0, 112, 255, 51, 0, 255, 0, 194, 255,
    0, 122, 255, 0, 255, 163, 255, 153, 0, 0, 255, 10, 255, 112, 0, 143,
    255, 0, 82, 0, 255, 163, 255, 0, 255, 235, 0, 8, 184, 170, 133, 0, 255,
    0, 255, 92, 184, 0, 255, 255, 0, 31, 0, 184, 255, 0, 214, 255, 255, 0,
    112, 92, 255, 0, 0, 224, 255, 112, 224, 255, 70, 184, 160, 163, 0, 255,
    153, 0, 255, 71, 255, 0, 255, 0, 163, 255, 204, 0, 255, 0, 143, 0, 255,
    235, 133, 255, 0, 255, 0, 235, 245, 0, 255, 255, 0, 122, 255, 245, 0,
    10, 190, 212, 214, 255, 0, 0, 204, 255, 20, 0, 255, 255, 255, 0, 0, 153,
    255, 0, 41, 255, 0, 255, 204, 41, 0, 255, 41, 255, 0, 173, 0, 255, 0,
    245, 255, 71, 0, 255, 122, 0, 255, 0, 255, 184, 0, 92, 255, 184, 255, 0,
    0, 133, 255, 255, 214, 0, 25, 194, 194, 102, 255, 0, 92, 0, 255,
]


def ade20k_official_palette() -> np.ndarray:
    """[151, 3] uint8; row 0 is the unlabeled colour."""
    return np.asarray(ADE20K_PALETTE_FLAT, np.uint8).reshape(-1, 3)


class ADE20kDataset:
    """Segmentation-to-image generation (ade20k.py:9-225).

    Layout: {data_root}/images/{phase}/{id}.jpg (photos),
    {data_root}/annotations_with_color/{phase}/{id}.png (palette-rendered
    segm), {data_root}/annotations/{phase}/{id}.png (class-id maps);
    {annt_root}/{phase}.json = [{"image_id", "caption"}].

    Eval items are StoryCollator dicts: round 0 = the colour-rendered segm
    map as context, round 1 = the target photo slot (text layout
    ``[img][caption.][img]``, ade20k.py:136-148 text_first=False).
    """

    name = "ade20k"

    def __init__(self, data_root: str, annt_root: str, transform: Callable,
                 phase: str = "validation",
                 total_length: Optional[int] = None, text_first: bool = False,
                 loader=None):
        self.data_root = data_root
        self.annt_root = annt_root
        self.transform = transform
        self.phase = phase
        self.text_first = text_first
        self.loader = loader or LocalLoader()
        with open(os.path.join(annt_root, f"{phase}.json")) as f:
            self.items = json.load(f)
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def image_id_to_path(self, idx: int) -> str:
        return os.path.join(self.data_root, "images", self.phase,
                            f"{self.items[idx]['image_id']}.jpg")

    def gt_id_to_path(self, idx: int) -> str:
        return os.path.join(self.data_root, "annotations", self.phase,
                            f"{self.items[idx]['image_id']}.png")

    def color_annt_path(self, idx: int) -> str:
        return os.path.join(self.data_root, "annotations_with_color",
                            self.phase, f"{self.items[idx]['image_id']}.png")

    @cached_property
    def palette(self) -> np.ndarray:
        return ade20k_official_palette()

    def __getitem__(self, idx):
        item = self.items[idx]
        annt = self.transform(
            self.loader.load_image(self.color_annt_path(idx))
        )
        photo = self.transform(
            self.loader.load_image(self.image_id_to_path(idx))
        )
        cap = item["caption"] + "."
        sentences = [cap, ""] if self.text_first else ["", cap]
        return dict(
            sentences=sentences,
            images=[annt, photo],
            target_rounds=[1],
            index=idx,
            story_id=item["image_id"],
        )


# --------------------------------------------------------------------- #
# storytelling benchmarks                                                #
# --------------------------------------------------------------------- #

def _crop_frame(pil_img, frame_idx: int, frame_h: int = 128):
    """Story frames are stacked vertically in one tall image; pick one
    (pororo.py:149-156)."""
    arr = np.asarray(pil_img).astype(np.uint8)
    arr = arr[frame_idx * frame_h: (frame_idx + 1) * frame_h]
    return Image.fromarray(arr, "RGB").convert("RGB")


class PororoDataset:
    """Pororo-SV storytelling (pororo.py:10-265): npy caches — descriptions,
    img_cache4 (bytes paths), following_cache4, train_seen_unseen_ids.
    5-frame stories; eval generates the last frame from the first four
    (context_type='multi_modal')."""

    name = "pororo"
    main_characters = [
        "Pororo", "Loopy", "Eddy", "Harry", "Poby", "Tongtong", "Crong",
        "Rody", "Petty",
    ]
    frame_h = 128

    def __init__(self, data_root: str, annt_root: str, transform: Callable,
                 phase: str = "test", context_type: str = "multi_modal",
                 total_length: Optional[int] = None, seed: int = 0,
                 loader=None):
        self.data_root = data_root
        self.transform = transform
        self.context_type = context_type
        self.loader = loader or LocalLoader()
        self.rng = np.random.RandomState(seed)

        self.descriptions = np.load(
            os.path.join(annt_root, "descriptions.npy"),
            allow_pickle=True, encoding="latin1",
        ).item()
        self.imgs_list = np.load(
            os.path.join(annt_root, "img_cache4.npy"), encoding="latin1"
        )
        self.followings_list = np.load(
            os.path.join(annt_root, "following_cache4.npy")
        )
        ids = np.load(
            os.path.join(annt_root, "train_seen_unseen_ids.npy"),
            allow_pickle=True,
        )
        self.annts = np.sort(ids[{"train": 0, "val": 1, "test": 2}[phase]])
        if total_length:
            self.annts = self.annts[:total_length]

    def __len__(self):
        return len(self.annts)

    @staticmethod
    def _bytes_path(b) -> str:
        # npy cache stores python-bytes reprs like b'path.png'
        s = str(b)
        return s[2:-1] if s.startswith("b'") else s

    def _global_ids(self, item_id: int) -> List[str]:
        return [self._bytes_path(self.imgs_list[item_id])] + [
            self._bytes_path(self.followings_list[item_id][i])
            for i in range(4)
        ]

    def _caption(self, global_id: str) -> str:
        cap = self.descriptions[global_id.replace(".png", "")][0].lower()
        for ch in self.main_characters:
            if ch.lower() in cap:
                cap = cap.replace(ch.lower(), ch)
        return cap.replace("\n", "").replace("\t", "").strip()

    def _frame(self, path: str, frame_idx: int = -1):
        img = self.loader.load_image(os.path.join(self.data_root, path))
        n = np.asarray(img).shape[0] // self.frame_h
        if frame_idx < 0:
            frame_idx = int(self.rng.randint(0, max(n, 1)))
        return self.transform(_crop_frame(img, frame_idx, self.frame_h)), \
            frame_idx

    def meta_to_image(self, meta, target_image_idx: int = -1):
        """(item_id, frame_idxs) -> gt PIL frame (pororo.py:117-132), for
        FID ground truth."""
        item_id, frame_idxs = meta
        gid = self._global_ids(int(item_id))[target_image_idx]
        img = self.loader.load_image(os.path.join(self.data_root, gid))
        return _crop_frame(img, frame_idxs[target_image_idx], self.frame_h)

    def __getitem__(self, idx):
        item_id = int(self.annts[idx])
        gids = self._global_ids(item_id)
        captions = [self._caption(g) for g in gids]
        images, frame_idxs, sentences = [], [], []
        for i, g in enumerate(gids):
            img, fi = self._frame(g)
            images.append(img)
            frame_idxs.append(fi)
            if self.context_type == "image_only" and i < len(gids) - 1:
                sentences.append("")
            else:
                sentences.append(captions[i])
        if self.context_type == "text_only":
            # context images dropped; only the target slot remains
            images = images[-1:]
            sentences = [" ".join(captions[:-1]) + " " + captions[-1]]
        return dict(
            sentences=sentences,
            images=images,
            target_rounds=[len(images) - 1],
            index=idx,
            story_id=str(item_id),
            frame_idxs=frame_idxs,
        )


class FlintStonesDataset(PororoDataset):
    """FlintStones-SV (flintstones.py:11-257): following_cache4.pkl +
    train-val-test_split.json + flintstones_annotations_v1-0.json; frames
    under video_frames_sampled_png/."""

    name = "flintstones"
    main_characters = [
        "Fred", "Barney", "Wilma", "Betty", "Pebbles", "Dino", "Slate",
    ]

    def __init__(self, data_root: str, annt_root: str, transform: Callable,
                 phase: str = "test", context_type: str = "multi_modal",
                 total_length: Optional[int] = None, seed: int = 0,
                 loader=None):
        self.data_root = data_root
        self.transform = transform
        self.context_type = context_type
        self.loader = loader or LocalLoader()
        self.rng = np.random.RandomState(seed)

        with open(os.path.join(annt_root, "following_cache4.pkl"), "rb") as f:
            self.followings_list = pickle.load(f)
        with open(os.path.join(
            annt_root, "train-val-test_split.json"
        )) as f:
            ids = json.load(f)[phase]
        self.annts = [
            i for i in ids
            if i in self.followings_list and len(self.followings_list[i]) == 4
        ]
        with open(os.path.join(
            annt_root, "flintstones_annotations_v1-0.json"
        )) as f:
            self.descriptions = {
                s["globalID"]: s["description"] for s in json.load(f)
            }
        if total_length:
            self.annts = self.annts[:total_length]

    def _global_ids(self, item_id) -> List[str]:
        return [item_id] + list(self.followings_list[item_id])

    def _caption(self, global_id: str) -> str:
        cap = self.descriptions[global_id].lower()
        for ch in self.main_characters:
            if ch.lower() in cap:
                cap = cap.replace(ch.lower(), ch)
        return cap.replace("\n", "").replace("\t", "").strip()

    def _frame(self, global_id: str, frame_idx: int = -1):
        img = self.loader.load_image(os.path.join(
            self.data_root, "video_frames_sampled_png", f"{global_id}.png"
        ))
        n = np.asarray(img).shape[0] // self.frame_h
        if frame_idx < 0:
            frame_idx = int(self.rng.randint(0, max(n, 1)))
        return self.transform(_crop_frame(img, frame_idx, self.frame_h)), \
            frame_idx

    def meta_to_image(self, meta, target_image_idx: int = -1):
        item_id, frame_idxs = meta
        gid = self._global_ids(item_id)[target_image_idx]
        img = self.loader.load_image(os.path.join(
            self.data_root, "video_frames_sampled_png", f"{gid}.png"
        ))
        return _crop_frame(img, frame_idxs[target_image_idx], self.frame_h)

    def __getitem__(self, idx):
        item_id = self.annts[idx]
        gids = self._global_ids(item_id)
        captions = [self._caption(g) for g in gids]
        images, frame_idxs, sentences = [], [], []
        for i, g in enumerate(gids):
            img, fi = self._frame(g)
            images.append(img)
            frame_idxs.append(fi)
            sentences.append(
                "" if self.context_type == "image_only" and i < len(gids) - 1
                else captions[i]
            )
        return dict(
            sentences=sentences,
            images=images,
            target_rounds=[len(images) - 1],
            index=idx,
            story_id=str(item_id),
            frame_idxs=frame_idxs,
        )


class VISTDataset:
    """VIST visual storytelling (vist.py:8-196): annotations/
    {phase}_formatted_filtered.json with per-story sequence_index-sorted
    turns; images under images/{phase}_images/{image_id}.png.

    collate_mode='generate_images' emits StoryCollator dicts;
    'generate_texts' emits MultiImageCollator generate dicts (the model
    writes the last caption given all frames + preceding captions).
    ``round_range='all'`` expands each story into per-round prefixes
    (vist.py:78-86)."""

    name = "vist"

    def __init__(self, data_root: str, annt_root: str, transform: Callable,
                 phase: str = "val", collate_mode: str = "generate_texts",
                 round_range: str = "last", context_type: str = "multi_modal",
                 total_length: Optional[int] = None, loader=None):
        assert collate_mode in ("generate_texts", "generate_images")
        assert round_range in ("last", "all")
        self.data_root = data_root
        self.transform = transform
        self.phase = phase
        self.collate_mode = collate_mode
        self.context_type = context_type
        self.loader = loader or LocalLoader()

        with open(os.path.join(
            annt_root, "annotations", f"{phase}_formatted_filtered.json"
        )) as f:
            annts = json.load(f)["annotations"]
        data = []
        for k, v in annts.items():
            v = sorted(v, key=lambda x: x["sequence_index"])
            data.append(dict(story_id=k, story=v))
        data.sort(key=lambda x: x["story_id"])
        if round_range == "all":
            data = [
                dict(story_id=f"{d['story_id']}_{i}", story=d["story"][:i])
                for d in data for i in range(1, len(d["story"]))
            ]
        self.items = data
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def _image(self, image_id):
        return self.transform(self.loader.load_image(os.path.join(
            self.data_root, "images", f"{self.phase}_images",
            f"{image_id}.png"
        )))

    def __getitem__(self, idx):
        story = self.items[idx]["story"]
        story_id = self.items[idx]["story_id"]
        if self.collate_mode == "generate_images":
            sentences = [t["caption"] for t in story]
            images = [self._image(t["image_id"]) for t in story]
            if self.context_type == "image_only":
                sentences = [""] * (len(story) - 1) + [story[-1]["caption"]]
            return dict(
                sentences=sentences, images=images,
                target_rounds=[len(images) - 1], index=idx,
                story_id=story_id,
            )
        # generate_texts: context rounds then the target frame; model writes
        # the last caption
        parts = []
        images = []
        for t in story[:-1]:
            if self.context_type != "image_only":
                parts.append(t["caption"])
            if self.context_type != "text_only":
                parts.append("<image>")
                images.append(self._image(t["image_id"]))
        if self.context_type != "text_only":
            parts.append("<image>")
            images.append(self._image(story[-1]["image_id"]))
        return dict(
            images=images,
            prompt=" ".join(parts),
            response=story[-1]["caption"],
            index=idx,
        )

    def references(self):
        return {
            i: [it["story"][-1]["caption"]]
            for i, it in enumerate(self.items)
        }


# --------------------------------------------------------------------- #
# grounding benchmarks                                                   #
# --------------------------------------------------------------------- #

class RegionCaptionDataset:
    """Region captioning, coco-format annotations
    (grounding_datasets.py:256-288): {"annotations": [{"image_id", "image",
    "caption", optional "query"/"bbox" (x1y1x2y2 pixels)}]}.
    Yields (image, query_or_caption, box01, idx); box01 zeros when absent."""

    name = "region_caption"

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 total_length: Optional[int] = None, loader=None):
        self.data_root = data_root
        self.transform = transform
        self.loader = loader or LocalLoader()
        with open(annt_file) as f:
            self.items = json.load(f)["annotations"]
        if total_length:
            self.items = self.items[:total_length]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            os.path.join(self.data_root, item["image"])
        )
        w, h = img.size
        box = item.get("bbox")
        box01 = ([box[0] / w, box[1] / h, box[2] / w, box[3] / h]
                 if box else [0.0, 0.0, 0.0, 0.0])
        return self.transform(img), item["caption"], box01, idx

    def references(self):
        return {i: [it["caption"]] for i, it in enumerate(self.items)}


class GroundedCaptionDataset:
    """Grounded captions with inline <ref>..</ref><box>(x1,y1)(x2,y2)</box>
    markup (grounding_datasets.py:290-367): jsonl rows {"image", "sent"}.
    Boxes rescale from pixels to the collator's box_scale grid at load."""

    name = "grounded_caption"

    def __init__(self, annt_file: str, data_root: str, transform: Callable,
                 box_scale: int = 999, total_length: Optional[int] = None,
                 loader=None):
        self.data_root = data_root
        self.transform = transform
        self.box_scale = box_scale
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

    @staticmethod
    def extract_objects(sent: str):
        """ref-text -> [box strings] (grounding_datasets.py:327-347)."""
        import re

        objects, last = {}, None
        for item in re.findall(r"<.*?>.*?<.*?>", sent):
            clean = re.sub(r"<.*?>", "", item)
            if item.startswith("<ref>"):
                last = clean
                objects[last] = []
            elif item.startswith("<box>") and last is not None:
                objects[last].append(clean)
        return objects

    @staticmethod
    def rescale_boxes(sent: str, height: int, width: int, scale: int) -> str:
        """Pixel boxes -> integer grid (grounding_datasets.py:349-364)."""
        import re

        boxes = set()
        for v in GroundedCaptionDataset.extract_objects(sent).values():
            boxes.update(v)
        for box in boxes:
            x1y1, x2y2 = re.findall(r"\((.*?)\)", box)
            x1, y1 = (float(t) for t in x1y1.split(","))
            x2, y2 = (float(t) for t in x2y2.split(","))
            x1, x2 = int(x1 / width * scale), int(x2 / width * scale)
            y1, y2 = int(y1 / height * scale), int(y2 / height * scale)
            sent = sent.replace(box, f"({x1:03d},{y1:03d})({x2:03d},{y2:03d})")
        return sent

    def __getitem__(self, idx):
        item = self.items[idx]
        img = self.loader.load_image(
            os.path.join(self.data_root, item["image"])
        )
        w, h = img.size
        sent = self.rescale_boxes(item["sent"], h, w, self.box_scale)
        return self.transform(img), sent, [0.0, 0.0, 0.0, 0.0], idx


def _rank_and_world(distributed: bool):
    """``(rank, world size)`` of this process in the initialised
    `torch.distributed` group when ``distributed``; ``(0, 1)`` otherwise."""
    import torch.distributed as dist

    if distributed and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class IterableKosmos2Dataset:
    """GRIT/Kosmos-2 grounding shards (grounding_datasets.py:448-536):
    {annt_root}/{filename_template.format(i)} jsonl rows {"image", "bbox"
    (pixels), "confidence", answer_key, optional query_key}; streams with a
    confidence filter and a per-process modulo stripe: with
    ``distributed`` and an initialised `torch.distributed` process group,
    line i goes to rank ``i % world_size``; otherwise every line to the one
    process)."""

    name = "kosmos2_grounding"

    def __init__(self, data_root: str, annt_root: str, answer_key: str,
                 transform: Callable, query_key: Optional[str] = None,
                 confidence_threshold: float = 0.0, start_idx: int = 0,
                 end_idx: int = 1,
                 filename_template: str = "train_grounding_{i}.jsonl",
                 dataset_len: Optional[int] = None, distributed: bool = False,
                 loader=None):
        self.data_root = data_root
        self.annt_root = annt_root
        self.answer_key = answer_key
        self.query_key = query_key
        self.transform = transform
        self.confidence_threshold = confidence_threshold
        self.start_idx = start_idx
        self.end_idx = end_idx
        self.filename_template = filename_template
        self.distributed = distributed
        self.loader = loader or LocalLoader()
        self._len = dataset_len

    def __len__(self):
        if self._len is None:
            raise TypeError("dataset_len not provided")
        return self._len

    def __iter__(self):
        rank, world = _rank_and_world(self.distributed)
        for i in range(self.start_idx, self.end_idx):
            path = os.path.join(
                self.annt_root, self.filename_template.format(i=i)
            )
            with open(path) as f:
                for line_idx, line in enumerate(f):
                    if line_idx % world != rank or not line.strip():
                        continue
                    ann = json.loads(line)
                    if ann.get("confidence", 1.0) < self.confidence_threshold:
                        continue
                    img = self.loader.load_image(
                        os.path.join(self.data_root, ann["image"])
                    )
                    w, h = img.size
                    x1, y1, x2, y2 = ann["bbox"]
                    box01 = [x1 / w, y1 / h, x2 / w, y2 / h]
                    expr = ann[self.query_key or self.answer_key]
                    yield self.transform(img), expr, box01, -1


# --------------------------------------------------------------------- #
# CLIP feature datasets (RICES retrieval + CLIP-i2i metric inputs)       #
# --------------------------------------------------------------------- #

class CLIPImageTextPairDataset:
    """(image_tensor, caption, idx) over generated-image dirs
    (clip_itp.py:8-46); `processor` maps a PIL image to the CLIP input
    tensor (defaults to the dataset transform)."""

    def __init__(self, image_root: str, caption_list: dict,
                 processor: Callable, loader=None):
        self.image_root = image_root
        self.caption_list = caption_list
        self.processor = processor
        self.loader = loader or LocalLoader()

    def __len__(self):
        return len(self.caption_list)

    def __getitem__(self, idx):
        caption = self.caption_list[str(idx)]["caption"]
        img = self.loader.load_image(
            os.path.join(self.image_root, f"{idx:05d}.png")
        )
        return self.processor(img), caption, idx


class CLIPImagePairDataset:
    """(generated, ground-truth) image pairs for the CLIP-i2i similarity
    metric (clip_itp.py:49-93)."""

    def __init__(self, image_pair_list: List[dict], processor: Callable,
                 loader=None):
        self.image_pair_list = image_pair_list
        self.processor = processor
        self.loader = loader or LocalLoader()

    def __len__(self):
        return len(self.image_pair_list)

    def __getitem__(self, idx):
        pair = self.image_pair_list[idx]
        img = self.processor(self.loader.load_image(pair["image_path"]))
        gt = self.processor(self.loader.load_image(pair["image_gt_path"]))
        return img, gt, idx
