"""Synthetic evaluation and inference inputs: seeded jpgs and the
annotation files of each eval route, in the official formats the datasets
read, so that the `evaluate` and `inference` entry points run end to end
with no dataset on disk.

`write_eval_assets(root)` returns the ``data.val`` stanzas of six routes:
COCO captioning, VQA (beam 3), VisDial ranking, grounding, COCO text to
image and storytelling; `write_bench_assets(root)` writes the files of the
eight benchmark sets of `data.datasets_bench`, each in its official
layout, and returns their nine stanzas (VIST twice: storytelling and
captioning its last frame).
`write_inference_assets(root)` returns the path of an ``annt.json`` of two
images.
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


def _frames(path: str, rng: np.random.RandomState, n_frames: int,
            frame_h: int = 128, width: int = 96) -> None:
    """A story clip: ``n_frames`` random frames of ``frame_h`` rows stacked
    vertically in one PNG, as the Pororo and FlintStones caches store
    them."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = rng.randint(0, 256, (n_frames * frame_h, width, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


def write_bench_assets(root: str, n: int = 2, seed: int = 0) -> List[Dict]:
    """Files of ``n`` samples of each `datasets_bench` set under ``root``,
    in each one's official layout, and their ``data.val`` stanzas: nocaps
    and Flickr30k (COCO-format json), the Stanford image paragraphs
    (``annotations/paragraphs_coco.json`` and ``test_split.json``), LN-COCO
    (``coco_val_captions.jsonl``, ``val2017/<id:012d>.jpg``), VIST
    (``annotations/val_formatted_filtered.json``,
    ``images/val_images/<id>.png``), Pororo (the four npy caches), FlintStones
    (``following_cache4.pkl``, the split and annotation jsons,
    ``video_frames_sampled_png/``) and ADE20k (``images/``,
    ``annotations/`` class maps, ``annotations_with_color/`` rendered by
    `prepare_ade20k`, ``validation.json``)."""
    import pickle

    from ..prepare_ade20k import render_split

    rng = np.random.RandomState(seed + 10)
    os.makedirs(root, exist_ok=True)

    cap_dir = os.path.join(root, "coco_style")
    names = [f"cap{i}.jpg" for i in range(n)]
    write_images(cap_dir, names, seed + 11)
    coco = {"images": [{"id": 10 + i, "file_name": names[i]}
                       for i in range(n)],
            "annotations": [{"image_id": 10 + i, "caption": _sentence(rng),
                             "id": k} for i in range(n) for k in range(2)]}
    nocaps = _dump(os.path.join(root, "nocaps_val.json"), coco)
    flickr = _dump(os.path.join(root, "flickr30k_test1k.json"), coco)

    para = os.path.join(root, "image2paragraph")
    os.makedirs(os.path.join(para, "annotations"), exist_ok=True)
    write_images(os.path.join(para, "images", "VG_100K"),
                 [f"{20 + i}.jpg" for i in range(n)], seed + 12)
    _dump(os.path.join(para, "annotations", "paragraphs_coco.json"), {
        "annotations": [{"image_id": 20 + i, "url": "https://cs.stanford.edu"
                         f"/people/rak248/VG_100K/{20 + i}.jpg",
                         "caption": ". ".join(_sentence(rng)
                                              for _ in range(3))}
                        for i in range(n + 1)]})
    _dump(os.path.join(para, "annotations", "test_split.json"),
          [20 + i for i in range(n)])

    lncoco = os.path.join(root, "lncoco")
    write_images(os.path.join(lncoco, "val2017"),
                 [f"{30 + i:012d}.jpg" for i in range(n)], seed + 13)
    _dump_jsonl(os.path.join(lncoco, "coco_val_captions.jsonl"),
                [{"image_id": 30 + i, "caption": _sentence(rng, 10)}
                 for i in range(n)])

    vist = os.path.join(root, "vist")
    os.makedirs(os.path.join(vist, "annotations"), exist_ok=True)
    vist_ids = [f"{40 + k}" for k in range(3 * n)]
    write_images(os.path.join(vist, "images", "val_images"),
                 [f"{i}.png" for i in vist_ids], seed + 14)
    _dump(os.path.join(vist, "annotations", "val_formatted_filtered.json"), {
        "annotations": {f"story{s}": [
            {"sequence_index": j, "caption": _sentence(rng),
             "image_id": vist_ids[3 * s + j]} for j in (2, 0, 1)]
            for s in range(n)}})

    pororo = os.path.join(root, "pororo")
    ids = [f"ep{k}/frame{k}.png" for k in range(5 * n)]
    for path in ids:
        _frames(os.path.join(pororo, "data", path), rng, 2)
    np.save(os.path.join(pororo, "descriptions.npy"), np.array(
        {p[:-4]: [_sentence(rng).capitalize() + " pororo smiles."]
         for p in ids}, dtype=object))
    np.save(os.path.join(pororo, "img_cache4.npy"),
            np.array([ids[5 * s].encode() for s in range(n)]))
    np.save(os.path.join(pororo, "following_cache4.npy"),
            np.array([[p.encode() for p in ids[5 * s + 1:5 * s + 5]]
                      for s in range(n)]))
    split = np.empty(3, dtype=object)
    split[0], split[1] = np.array([], np.int64), np.array([], np.int64)
    split[2] = np.arange(n)[::-1].copy()
    np.save(os.path.join(pororo, "train_seen_unseen_ids.npy"), split)

    flint = os.path.join(root, "flintstones")
    gids = [f"s_{k:02d}_e_01_shot_{k:06d}" for k in range(5 * n)]
    for g in gids:
        _frames(os.path.join(flint, "data", "video_frames_sampled_png",
                             f"{g}.png"), rng, 3)
    with open(os.path.join(flint, "following_cache4.pkl"), "wb") as f:
        pickle.dump({gids[5 * s]: gids[5 * s + 1:5 * s + 5]
                     for s in range(n)}, f)
    _dump(os.path.join(flint, "train-val-test_split.json"),
          {"train": [], "val": [], "test": [gids[5 * s] for s in range(n)]})
    _dump(os.path.join(flint, "flintstones_annotations_v1-0.json"), [
        {"globalID": g, "description": "Fred " + _sentence(rng)}
        for g in gids])

    ade = os.path.join(root, "ade20k")
    ade_ids = [f"ADE_val_{k:08d}" for k in range(1, n + 1)]
    write_images(os.path.join(ade, "images", "validation"),
                 [f"{i}.jpg" for i in ade_ids], seed + 15)
    os.makedirs(os.path.join(ade, "annotations", "validation"), exist_ok=True)
    for i in ade_ids:
        segm = np.repeat(np.repeat(rng.randint(0, 151, (8, 10)), 10, 0), 10, 1)
        Image.fromarray(segm.astype(np.uint8)).save(
            os.path.join(ade, "annotations", "validation", f"{i}.png"))
    render_split(ade, "validation")
    _dump(os.path.join(ade, "validation.json"),
          [{"image_id": i, "caption": _sentence(rng)} for i in ade_ids])

    return [
        dict(type="nocaps", dataset_name="synthetic_nocaps",
             annt_file=nocaps, data_root=cap_dir),
        dict(type="flickr30k", dataset_name="synthetic_flickr30k",
             annt_file=flickr, data_root=cap_dir),
        dict(type="image2paragraph", dataset_name="synthetic_image2paragraph",
             annt_root=para, data_root=os.path.join(para, "images")),
        dict(type="lncoco", dataset_name="synthetic_lncoco",
             annt_root=lncoco, data_root=lncoco),
        dict(type="vist", dataset_name="synthetic_vist", annt_root=vist,
             data_root=vist),
        dict(type="vist", dataset_name="synthetic_vist_caption",
             annt_root=vist, data_root=vist, collate_mode="generate_texts"),
        dict(type="pororo", dataset_name="synthetic_pororo",
             annt_root=pororo, data_root=os.path.join(pororo, "data")),
        dict(type="flintstones", dataset_name="synthetic_flintstones",
             annt_root=flint, data_root=os.path.join(flint, "data")),
        dict(type="ade20k", dataset_name="synthetic_ade20k", annt_root=ade,
             data_root=ade),
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
