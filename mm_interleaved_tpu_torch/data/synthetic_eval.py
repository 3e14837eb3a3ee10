"""Synthetic evaluation and inference inputs: seeded jpgs and the
annotation files of each eval route, in the official formats the datasets
read, so that the `evaluate` and `inference` entry points run end to end
with no dataset on disk.

`write_eval_assets(root)` returns the ``data.val`` stanzas of six routes:
COCO captioning, VQA (beam 3), VisDial ranking, grounding, COCO text to
image and storytelling.  `write_inference_assets(root)` returns the path of
an ``annt.json`` of two images.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
from PIL import Image

WORDS = ("a", "small", "red", "dog", "on", "the", "grass", "near", "two",
         "people", "with", "blue", "sky", "and", "trees")


def _sentence(rng: np.random.RandomState, n: int = 6) -> str:
    return " ".join(rng.choice(WORDS, n))


def write_images(root: str, names: List[str], seed: int = 0,
                 size=(80, 100)) -> None:
    """Seeded random RGB jpgs ``root/<name>`` of ``size`` (h, w)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        arr = rng.randint(0, 256, size + (3,), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, name))


def _dump(path: str, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def _dump_jsonl(path: str, rows) -> str:
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return path


def write_eval_assets(root: str, n: int = 2, seed: int = 0,
                      n_options: int = 4) -> List[Dict]:
    """Images and annotations of ``n`` samples for each of the six routes
    under ``root``; returns their ``data.val`` stanzas."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    names = [f"img{i}.jpg" for i in range(n)]
    write_images(img_dir, names, seed)

    coco = _dump(os.path.join(root, "captions.json"), {
        "images": [{"id": i, "file_name": names[i]} for i in range(n)],
        "annotations": [{"image_id": i, "caption": _sentence(rng), "id": k}
                        for i in range(n) for k in (2 * i, 2 * i + 1)],
    })
    questions = _dump(os.path.join(root, "questions.json"), {
        "questions": [{"image_id": i, "question": _sentence(rng, 4) + "?",
                       "question_id": 100 + i} for i in range(n)]})
    answers = _dump(os.path.join(root, "answers.json"), {
        "annotations": [{"question_id": 100 + i,
                         "answers": [{"answer": w} for w in
                                     rng.choice(WORDS, 10)]}
                        for i in range(n)]})

    vd_names = [f"VisualDialog_val2018_{i:012d}.jpg" for i in range(n)]
    write_images(img_dir, vd_names, seed + 1)
    n_ans = 2 * n_options
    dialogs = _dump(os.path.join(root, "visdial.json"), {"data": {
        "questions": [_sentence(rng, 4) for _ in range(4)],
        "answers": [_sentence(rng, 3) for _ in range(n_ans)],
        "dialogs": [{"image_id": i, "caption": _sentence(rng), "dialog": [
            {"question": r % 4, "answer": r % n_ans,
             "answer_options": [int(a) for a in rng.choice(
                 n_ans, n_options, replace=False)]}
            for r in range(2)]} for i in range(n)]}})
    dense = _dump(os.path.join(root, "visdial_dense.json"), [
        {"image_id": i, "round_id": 2,
         "gt_relevance": [float(x) for x in rng.rand(n_options).round(2)]}
        for i in range(n)])

    grounding = _dump_jsonl(os.path.join(root, "grounding.jsonl"), [
        {"image": names[i], "expression": _sentence(rng, 3),
         "bbox": [10.0, 5.0, 60.0, 70.0], "width": 100, "height": 80}
        for i in range(n)])

    story_names = [f"story{i}.jpg" for i in range(3 * n)]
    write_images(img_dir, story_names, seed + 2)
    story = _dump_jsonl(os.path.join(root, "story.jsonl"), [
        {"story_id": f"s{i}", "sentences": [_sentence(rng) for _ in range(3)],
         "images": story_names[3 * i:3 * i + 3], "target_rounds": [1, 2]}
        for i in range(n)])

    return [
        dict(type="coco_caption", dataset_name="synthetic_caption",
             annt_file=coco, data_root=img_dir,
             collate_mode="generate_texts"),
        dict(type="vqa", dataset_name="synthetic_vqa",
             questions_file=questions, annotations_file=answers,
             data_root=img_dir, image_name_format="img{}.jpg",
             collate_mode="generate_vqa"),
        dict(type="visdial", dataset_name="synthetic_visdial",
             dialogs_file=dialogs, dense_file=dense, data_root=img_dir,
             collate_mode="generate_scores"),
        dict(type="grounding", dataset_name="synthetic_grounding",
             annt_file=grounding, data_root=img_dir),
        dict(type="coco_caption", dataset_name="synthetic_t2i",
             annt_file=coco, data_root=img_dir,
             collate_mode="generate_images"),
        dict(type="story", dataset_name="synthetic_story", annt_file=story,
             data_root=img_dir),
    ]


def write_inference_assets(root: str, seed: int = 0) -> str:
    """Two jpgs and an ``annt.json`` of one sample (text, image, text,
    image, text) under ``root``; returns the annt path (``root`` is its
    image root)."""
    write_images(root, ["img0.jpg", "img1.jpg"], seed)
    return _dump(os.path.join(root, "annt.json"), [{
        "sentences": ["a small test scene", "<|image|>", "then another",
                      "<|image|>", "describe them"],
        "images": ["img0.jpg", "img1.jpg"]}])
