"""The benchmark datasets, segmentation to image and RICES of the PyTorch
port against the JAX package's, on the synthetic files of
`data.synthetic_eval.write_bench_assets` (each set in its official layout):

  * every `datasets_bench` class yields JAX's items: images bit for bit,
    texts and meta exact, with the options the entry passes (VIST's
    ``round_range`` and ``collate_mode``, the story sets' ``context_type``,
    LN-COCO's oversampling), and JAX's helpers (references, image ids and
    paths, ``meta_to_image``); the Kosmos-2 stream's rank split, the region
    and grounded caption sets and the CLIP pair sets too;
  * the ADE20k helpers and ``python -m mm_interleaved_tpu_torch.
    prepare_ade20k`` against JAX's palette and ``scripts/prepare_ade20k.py``
    (the same PNG bytes' pixels);
  * `RICES` over the port's `CLIPViTFeatures` against JAX's `RICES` over
    JAX's, on the same noised tiny weights: the same indices, the features
    within 1e-4, the few-shot caption and VQA batches equal to JAX's;
  * the ade20k route with JAX's draws injected: images within 1e-4,
    ``num_generated`` and ``miou`` equal to JAX's under one segmenter;
  * `evaluate.main` on the CPU over the eight types (nine stanzas), one row
    each; VIST's captioning route, which JAX's `evaluate_caption` cannot
    unpack, scores its texts as JAX's metrics do.
"""

import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import mm_interleaved_tpu.data.datasets_bench as JB
from mm_interleaved_tpu.data import collators as JC
from mm_interleaved_tpu.data import datasets_extra as JX
from mm_interleaved_tpu.data.datasets import (
    VQADataset as JVQADataset, iterate_dataset as j_iterate)
from mm_interleaved_tpu.data.rices import RICES as JRICES
from mm_interleaved_tpu.data.transforms import create_transform as j_transform
from mm_interleaved_tpu.engine.evaluator import (
    EvalConfig as JEvalConfig, Evaluator as JEvaluator)
from mm_interleaved_tpu.utils import metrics as JM
from mm_interleaved_tpu.utils.fid import CLIPViTFeatures as JFeatures
from mm_interleaved_tpu_torch import evaluate, prepare_ade20k
from mm_interleaved_tpu_torch.data import collators as PC
from mm_interleaved_tpu_torch.data import datasets_bench as PB
from mm_interleaved_tpu_torch.data import datasets_extra as PX
from mm_interleaved_tpu_torch.data.datasets import (
    VQADataset, iterate_dataset)
from mm_interleaved_tpu_torch.data.rices import RICES
from mm_interleaved_tpu_torch.data.synthetic_eval import (
    write_bench_assets, write_eval_assets)
from mm_interleaved_tpu_torch.data.transforms import create_transform
from mm_interleaved_tpu_torch.engine.evaluator import EvalConfig, Evaluator
from mm_interleaved_tpu_torch.utils.fid import CLIPViTFeatures

from _torch_parity import one_native_build  # noqa: F401 (autouse)
from _torch_eval_parity import (REPO, InjectedPort, RecordingJax, jax_entry,
                                tiny_pair, tokenizers)

ATOL = 1e-4
RES = 56


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    return root, {s["dataset_name"]: s for s in write_bench_assets(root)}


def _equal(got, want, path="item"):
    """Recursive exact equality of dataset items (arrays bit for bit)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _pair(name, s, **kw):
    """The JAX and the port dataset of a stanza's files."""
    tj, tp = j_transform("numpy", resolution=RES), create_transform(
        "numpy", resolution=RES)
    if name in ("nocaps", "flickr30k"):
        cls = "NoCapsDataset" if name == "nocaps" else "Flickr30KDataset"
        args = (s["annt_file"], s["data_root"])
    elif name in ("image2paragraph", "lncoco"):
        cls = ("Image2ParagraphDataset" if name == "image2paragraph"
               else "LNCOCODataset")
        args = (s["annt_root"], s["data_root"])
    else:
        cls = {"vist": "VISTDataset", "pororo": "PororoDataset",
               "flintstones": "FlintStonesDataset",
               "ade20k": "ADE20kDataset"}[name]
        args = (s["data_root"], s["annt_root"])
    return (getattr(JB, cls)(*args, tj, **kw), getattr(PB, cls)(*args, tp,
                                                                **kw))


CASES = [
    ("synthetic_nocaps", {}), ("synthetic_nocaps", {"image_only": False}),
    ("synthetic_flickr30k", {"total_length": 1}),
    ("synthetic_image2paragraph", {}),
    ("synthetic_lncoco", {}), ("synthetic_lncoco", {"total_length": 5}),
    ("synthetic_lncoco", {"image_only": True}),
    ("synthetic_vist", {"collate_mode": "generate_images"}),
    ("synthetic_vist", {"collate_mode": "generate_texts",
                        "round_range": "all"}),
    ("synthetic_vist", {"collate_mode": "generate_texts",
                        "context_type": "text_only"}),
    ("synthetic_pororo", {}), ("synthetic_pororo",
                               {"context_type": "text_only"}),
    ("synthetic_flintstones", {"context_type": "image_only"}),
    ("synthetic_ade20k", {}), ("synthetic_ade20k", {"text_first": True}),
]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n[10:]}-{i}" for i, (n, _) in
                              enumerate(CASES)])
def test_bench_dataset_items_equal_jax(bench, name, kw):
    """Every item (twice through the story sets, whose frame draws advance
    a seeded stream) and every helper equal JAX's."""
    j, p = _pair(bench[1][name]["type"], bench[1][name], **kw)
    assert len(p) == len(j) > 0
    for _ in range(2 if "frame_h" in dir(j) else 1):
        for i in range(len(j)):
            _equal(p[i], j[i], f"{name}[{i}]")
    for helper in ("references", "image_ids"):
        if hasattr(j, helper):
            _equal(getattr(p, helper)(), getattr(j, helper)())
    for helper in ("image_id_to_path", "gt_id_to_path", "color_annt_path"):
        if hasattr(j, helper):
            arg = 0 if helper != "image_id_to_path" or hasattr(
                j, "gt_id_to_path") else j.items[0]["image_id"]
            assert getattr(p, helper)(arg) == getattr(j, helper)(arg)
    if hasattr(j, "meta_to_image"):
        meta = (j.annts[0], [0, 1, 0, 1, 1])
        _equal(np.asarray(p.meta_to_image(meta)),
               np.asarray(j.meta_to_image(meta)))
    if hasattr(j, "palette"):
        _equal(p.palette, j.palette)


def test_grounding_kosmos2_and_clip_sets_equal_jax(bench, tmp_path,
                                                   monkeypatch):
    """The region / grounded caption sets, the Kosmos-2 stream (one
    process, and rank 1 of 2 against JAX's process 1 of 2) and the CLIP
    image-text / image-pair sets yield JAX's items."""
    root = bench[0]
    img_root = os.path.join(root, "coco_style")
    names = sorted(os.listdir(img_root))
    tj, tp = j_transform("numpy", resolution=RES), create_transform(
        "numpy", resolution=RES)
    region = tmp_path / "region.json"
    region.write_text(json.dumps({"annotations": [
        {"image_id": i, "image": n, "caption": f"thing {i}",
         **({"bbox": [3, 4, 50, 60]} if i else {})}
        for i, n in enumerate(names)]}))
    a = (str(region), img_root)
    _equal([PB.RegionCaptionDataset(*a, tp)[i] for i in range(2)],
           [JB.RegionCaptionDataset(*a, tj)[i] for i in range(2)])
    _equal(PB.RegionCaptionDataset(*a, tp).references(),
           JB.RegionCaptionDataset(*a, tj).references())
    grounded = tmp_path / "grounded.jsonl"
    grounded.write_text("\n".join(json.dumps({
        "image": n, "sent": f"<ref>a dog</ref><box>({5 + i},7)(60,70)</box> "
                            "and <ref>sky</ref><box>(1,2)(99,30)</box>"})
        for i, n in enumerate(names)) + "\n")
    g = (str(grounded), img_root)
    _equal([PB.GroundedCaptionDataset(*g, tp)[i] for i in range(2)],
           [JB.GroundedCaptionDataset(*g, tj)[i] for i in range(2)])

    shard = tmp_path / "train_grounding_0.jsonl"
    shard.write_text("\n".join(json.dumps({
        "image": names[i % 2], "bbox": [2 * i, 3, 40, 50],
        "confidence": 0.2 * i, "caption": f"expr {i}", "query": f"q {i}"})
        for i in range(7)) + "\n")
    kw = dict(data_root=img_root, annt_root=str(tmp_path),
              answer_key="caption", query_key="query",
              confidence_threshold=0.3)
    one = list(PB.IterableKosmos2Dataset(transform=tp, distributed=True,
                                         **kw))
    _equal(one, list(JB.IterableKosmos2Dataset(transform=tj, **kw)))
    assert len(one) == 5
    import jax
    import torch.distributed as dist

    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    half = list(PB.IterableKosmos2Dataset(transform=tp, distributed=True,
                                          **kw))
    _equal(half, list(JB.IterableKosmos2Dataset(transform=tj,
                                                distributed=True, **kw)))
    assert [h[1] for h in half] == ["q 3", "q 5"]

    caps = {str(i): {"caption": f"c{i}"} for i in range(2)}
    for i in range(2):
        shutil.copy(os.path.join(img_root, names[i]),
                    tmp_path / f"{i:05d}.png")
    _equal([PB.CLIPImageTextPairDataset(str(tmp_path), caps, tp)[i]
            for i in range(2)],
           [JB.CLIPImageTextPairDataset(str(tmp_path), caps, tj)[i]
            for i in range(2)])
    pairs = [{"image_path": os.path.join(img_root, names[i]),
              "image_gt_path": os.path.join(img_root, names[1 - i])}
             for i in range(2)]
    _equal([PB.CLIPImagePairDataset(pairs, tp)[i] for i in range(2)],
           [JB.CLIPImagePairDataset(pairs, tj)[i] for i in range(2)])


def test_ade20k_helpers_and_prepare_equal_jax(bench, tmp_path):
    """The palette, `segm_to_rgb` and `rgb_to_segm` equal JAX's; the port's
    ``prepare_ade20k`` writes the pixels JAX's script writes."""
    np.testing.assert_array_equal(PX.ade20k_palette(), JX.ade20k_palette())
    np.testing.assert_array_equal(PX.ade20k_palette(20),
                                  JX.ade20k_palette(20))
    rs = np.random.RandomState(0)
    segm = rs.randint(-3, 160, (9, 7))
    pal = PX.ade20k_palette()
    np.testing.assert_array_equal(PX.segm_to_rgb(segm, pal),
                                  JX.segm_to_rgb(segm, pal))
    img = rs.rand(9, 7, 3).astype(np.float32)
    np.testing.assert_array_equal(PX.rgb_to_segm(img, pal),
                                  JX.rgb_to_segm(img, pal))
    np.testing.assert_array_equal(
        PX.rgb_to_segm(PX.segm_to_rgb(segm.clip(0, 149), pal), pal),
        segm.clip(0, 149))

    ade = bench[1]["synthetic_ade20k"]["data_root"]
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_ade20k", os.path.join(REPO, "scripts",
                                           "prepare_ade20k.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    for tag, run in (("jax", lambda d: jmod.render_split(d, "validation")),
                     ("port", lambda d: prepare_ade20k.main(
                         ["--data_root", d]))):
        d = tmp_path / tag
        shutil.copytree(os.path.join(ade, "images"), d / "images")
        shutil.copytree(os.path.join(ade, "annotations"), d / "annotations")
        run(str(d))
    from PIL import Image

    out = sorted(os.listdir(tmp_path / "jax" / "annotations_with_color" /
                            "validation"))
    assert out and out == sorted(os.listdir(
        tmp_path / "port" / "annotations_with_color" / "validation"))
    for n in out:
        got, want = (np.asarray(Image.open(
            tmp_path / tag / "annotations_with_color" / "validation" / n))
            for tag in ("port", "jax"))
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, params, model = tiny_pair(with_image_decoder=True)
    jtok, ptok = tokenizers(jcfg, model.cfg)
    return jcfg, jmodel, params, model, jtok, ptok


def test_rices_picks_and_few_shot_batches_equal_jax(pair, tmp_path):
    """RICES over a support set of six captioned images (and of six VQA
    samples): the port's `CLIPViTFeatures` on the tiny ViT give JAX's
    features within 1e-4 and JAX's top-3 indices; the few-shot caption and
    VQA batches built on them equal JAX's bit for bit."""
    jcfg, _, params, model, jtok, ptok = pair
    enc = params["params"]["visual_tokenizer"]["encoder"]
    jf = JFeatures(jcfg.visual.encoder.vit, {"params": enc})
    pf = CLIPViTFeatures(model.visual_tokenizer.encoder)
    root = str(tmp_path)
    stanzas = {s["type"]: s for s in write_bench_assets(root, n=6, seed=3)}
    j_sup, p_sup = _pair("nocaps", stanzas["nocaps"])
    jr, pr = JRICES(j_sup, jf), RICES(p_sup, pf)
    np.testing.assert_allclose(pr.features, jr.features, rtol=0, atol=ATOL)
    queries = np.random.RandomState(4).rand(3, RES, RES, 3).astype(
        np.float32)
    assert pr.find(queries, 3) == jr.find(queries, 3)

    ntok = jcfg.num_img_token
    items = [p_sup[i] for i in range(2)]
    jcoll = JC.ImageTextPairCollator(
        jtok, jtok.special, num_img_token=ntok, mode="generate_texts",
        max_num_images=4, few_shot_k=3, rices=jr)
    pcoll = PC.ImageTextPairCollator(
        ptok, ptok.special, num_img_token=ntok, mode="generate_texts",
        max_num_images=4, few_shot_k=3, rices=pr)
    _equal(pcoll(items), jcoll(items))

    eval_root = os.path.join(root, "vqa")
    vqa = next(s for s in write_eval_assets(eval_root, n=6)
               if s["type"] == "vqa")
    args = (vqa["questions_file"], vqa["annotations_file"], vqa["data_root"])
    kw = dict(image_name_format=vqa["image_name_format"])
    jv = JVQADataset(*args, j_transform("numpy", resolution=RES), **kw)
    pv = VQADataset(*args, create_transform("numpy", resolution=RES), **kw)
    jvr, pvr = JRICES(jv, jf), RICES(pv, pf)
    jcoll = JC.VQACollator(jtok, jtok.special, num_img_token=ntok,
                           few_shot_k=2, rices=jvr)
    pcoll = PC.VQACollator(ptok, ptok.special, num_img_token=ntok,
                           few_shot_k=2, rices=pvr)
    items = [pv[i] for i in range(3)]
    _equal(pcoll(items), jcoll(items))


def test_ade20k_route_matches_jax_with_injected_draws(pair, bench, tmp_path):
    """The same ade20k batches through both evaluators' segmentation to
    image (2 DDPM steps): images within 1e-4; ``num_generated`` and the
    mIoU of one segmenter (the nearest palette colour, 1-indexed) equal."""
    jcfg, jmodel, params, model, jtok, ptok = pair
    ds_cfg = bench[1]["synthetic_ade20k"]
    j_evaluate = jax_entry("evaluate")
    ds, coll, mode = j_evaluate.build_eval_dataset(ds_cfg, jcfg, jtok)
    assert mode == "generate_segm"
    batches = list(j_iterate(ds, 2, coll))
    gt = {i: np.asarray(__import__("PIL.Image").Image.open(
        ds.gt_id_to_path(i))) for i in range(len(ds))}
    pal = PX.ade20k_palette()

    def segment(img):
        return PX.rgb_to_segm(img, pal) + 1

    base = dict(batch_size=2, num_inference_steps=2)
    jrt = RecordingJax(jmodel, params)
    jev = JEvaluator(jmodel, params, jtok, JEvalConfig(
        output_dir=str(tmp_path / "jax"), **base), runtime=jrt)
    want = jev.evaluate_segm2img(iter(batches), gt, segment_fn=segment)
    prt = InjectedPort(model, jrt.draws)
    pev = Evaluator(model, ptok, EvalConfig(output_dir=str(tmp_path / "port"),
                                            **base), runtime=prt)
    got = pev.evaluate_segm2img(iter(batches), gt, segment_fn=segment)
    assert len(prt.images) == len(jrt.images) == 1 and not prt.draws
    np.testing.assert_allclose(prt.images[0], jrt.images[0], rtol=0,
                               atol=ATOL)
    assert got == want and got["num_generated"] == 2 and "miou" in got
    assert sorted(os.listdir(tmp_path / "port" / "ade20k")) == \
        sorted(os.listdir(tmp_path / "jax" / "ade20k"))


def test_evaluate_main_runs_the_eight_types_on_the_cpu(pair, bench,
                                                       tmp_path):
    """`evaluate.main` over the nine benchmark stanzas (the tiny preset with
    five image slots, one batch of 2, 2 steps): one row each in
    ``eval_metrics.jsonl``, the route each type takes, every image route
    generating; VIST's captioning batch (meta ``(index,)``, which JAX's
    `evaluate_caption` cannot unpack: `ValueError`) scored by the port's
    route as JAX's metrics score the same texts."""
    stanzas = list(bench[1].values())
    config = dict(
        output_dir=str(tmp_path / "out"),
        model=dict(preset="tiny", preset_kwargs=dict(max_num_images=5)),
        data=dict(tokenizer_path=None, val=stanzas),
        evaluation=dict(batch_size=2, max_batches=1, num_inference_steps=2,
                        max_new_tokens=4, num_beams=1))
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(config))
    results = evaluate.main(["--config", str(path), "--device", "cpu"])
    names = [s["dataset_name"] for s in stanzas]
    assert list(results) == names
    rows = [json.loads(x) for x in
            (tmp_path / "out" / "eval_metrics.jsonl").read_text().split("\n")
            if x]
    assert [r["dataset"] for r in rows] == names
    for name, r in results.items():
        if name[10:] in ("nocaps", "flickr30k", "image2paragraph",
                         "vist_caption"):
            assert r["num_samples"] == 2 and "CIDEr" in r, name
        else:
            assert r["num_generated"] == 2, (name, r)
    assert "miou" not in results["synthetic_ade20k"]

    jcfg, jmodel, params, model, jtok, ptok = pair
    s = bench[1]["synthetic_vist_caption"]
    ds, coll, mode = evaluate.build_eval_dataset(s, model.cfg, ptok)
    assert mode == "generate_texts"
    batch = next(iter(iterate_dataset(ds, 2, coll)))
    assert batch["meta"] == [(0,), (1,)]
    cfg = dict(batch_size=2, max_new_tokens=4, num_beams=1)
    texts = ["a dog", "two people"]
    jev = JEvaluator(jmodel, params, jtok, JEvalConfig(**cfg))
    jev._decode_batch = lambda b, c: texts  # the route's unpacking alone
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jev.evaluate_caption(iter([batch]), ds.references())
    pev = Evaluator(model, ptok, EvalConfig(**cfg))
    pev._decode_batch = lambda b, c: texts
    got = pev.evaluate_caption(iter([batch]), ds.references())
    refs = ds.references()
    want = {k: JM.cider_d(texts, [refs[0], refs[1]]) if k == "CIDEr"
            else JM.bleu(texts, [refs[0], refs[1]]) for k in ("CIDEr",
                                                                "BLEU4")}
    assert got["num_samples"] == 2
    assert {k: got[k] for k in want} == want
