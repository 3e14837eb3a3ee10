"""Zero-shot benchmark evaluation entry point of the PyTorch port
(counterpart of `evaluate.py`).

    python -m mm_interleaved_tpu_torch.evaluate --config configs/eval.yaml \
        [--checkpoint CKPT] [--output_dir OUT] [--device cuda|cpu]

Runs each eval dataset of ``data.val`` through its route of
`engine.evaluator.Evaluator`, with the reference's per-task generation
defaults (`resolve_eval_config`); each route appends one row to
``<output_dir>/eval_metrics.jsonl``.  ``evaluation.clip_fid`` gives the
image routes FID (and storytelling the CLIP image-image similarity) from
the model's own CLIP ViT.

Datasets: ``coco_caption``, ``vqa``, ``vizwiz_vqa``, ``image_text_jsonl``,
``visdial``, ``grounding`` and ``story``, and the benchmark sets of
`data.datasets_bench` (`BENCH_TYPES`): nocaps, flickr30k and
image2paragraph caption; lncoco goes to text to image; vist, pororo and
flintstones to storytelling (vist with ``collate_mode: generate_texts`` to
captioning its last frame); ade20k to segmentation to image, with no
segmenter (``num_generated`` only, as in the JAX entry).
``evaluation.quantize: int8`` runs the LLM with int8 weights
(`ops.quant`).  An orbax checkpoint is refused (``--checkpoint`` takes the
port's own checkpoints: ``python -m
mm_interleaved_tpu_torch.convert_checkpoint`` writes one from the released
weights).

A ``mesh:`` stanza over more than one device (``{fsdp: 4, tensor: 2}``)
runs the sharded runtime (`parallel.inference.ShardedGenerator`), one
process a device under torchrun::

    torchrun --nproc_per_node 8 -m mm_interleaved_tpu_torch.evaluate \
        --config configs/eval.yaml

(nccl on the card, rank r on ``cuda:LOCAL_RANK``; gloo with ``--device
cpu``).  Every rank runs every batch; rank 0 alone writes the images and
``eval_metrics.jsonl``.

The t2i rerank (a stanza's ``rerank_by_clip`` with ``num_candidates > 1``)
reads ``evaluation.clip_text_path``, an HF CLIP directory: both its towers
(`models.clip_text.load_clip`), the image side projected as HF's
``get_image_features`` so the two sides share one space, and its
tokenizer (transformers' ``CLIPTokenizer``, imported at use).  Without
``clip_text_path`` the rerank keeps candidate 0, as the JAX entry does.
Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Dict

import numpy as np

# Reference per-task generation defaults, applied when the dataset stanza
# does not override them (ImageTextPairCollator collator.py:199-205,
# VQACollator collator.py:543-549; the model maps max_length ->
# max_new_tokens at the generate call, mm_interleaved.py:647).
REF_TASK_DEFAULTS = {
    "generate_texts": dict(max_new_tokens=20, min_new_tokens=8,
                           length_penalty=1.0, num_beams=5, top_p=0.9),
    "generate_vqa": dict(max_new_tokens=10, min_new_tokens=0,
                         length_penalty=0.0, num_beams=3, top_p=1.0),
    # release t2i protocol (mm_eval.yaml:142-145); num_validation_images
    # defaults to 1 unless the stanza raises it
    "generate_images": dict(num_inference_steps=250, guidance_scale=3.5,
                            num_candidates=1),
}

# reference generation_kwargs key -> EvalConfig field
_REF_KEY_ALIASES = {
    "max_length": "max_new_tokens",
    "min_length": "min_new_tokens",
    "num_validation_images": "num_candidates",
}

# the dataset types of `data.datasets_bench`
BENCH_TYPES = ("nocaps", "flickr30k", "image2paragraph", "lncoco", "vist",
               "pororo", "flintstones", "ade20k")


def resolve_eval_config(base_cfg, mode, ds_cfg, explicit_global=()):
    """Per-dataset EvalConfig: reference task defaults, then keys the user
    set explicitly in the global ``evaluation:`` section, then the dataset
    stanza's ``generation_kwargs`` (reference semantics: collator defaults
    overridden per-dataset, collator.py:206,369-371)."""
    values = {}
    for k, v in REF_TASK_DEFAULTS.get(mode, {}).items():
        if k not in explicit_global:
            values[k] = v
    for k, v in (ds_cfg.get("generation_kwargs") or {}).items():
        values[_REF_KEY_ALIASES.get(k, k)] = v
    known = {f.name for f in dataclasses.fields(type(base_cfg))}
    unknown = set(values) - known
    if unknown:
        raise ValueError(f"unknown generation_kwargs: {sorted(unknown)}")
    return dataclasses.replace(base_cfg, **values)


def build_eval_dataset(ds_cfg, model_cfg, tokenizer):
    """``(dataset, collator, mode)`` of a ``data.val`` stanza."""
    from .data.collators import ImageTextPairCollator, VQACollator
    from .data.collators_extra import (GroundingCollator, StoryCollator,
                                       VisDialCollator)
    from .data.datasets import (CocoCaptionDataset, ImageTextJsonlDataset,
                                VizWizVQADataset, VQADataset)
    from .data.datasets_extra import (GroundingDataset, StoryDataset,
                                      VisDialDenseDataset)
    from .data.transforms import create_transform

    name = ds_cfg["type"]
    enc_res = model_cfg.visual.encoder.vit.image_size
    transform = create_transform(
        aug_type=ds_cfg.get("transform", "numpy"), resolution=enc_res,
    )
    mode = ds_cfg.get("collate_mode", "generate_texts")
    total = ds_cfg.get("total_length")
    ntok = model_cfg.num_img_token
    if name == "coco_caption":
        ds = CocoCaptionDataset(
            ds_cfg["annt_file"], ds_cfg["data_root"], transform,
            total_length=total, phase=ds_cfg.get("phase", "test"),
        )
        coll = ImageTextPairCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 256), mode=mode,
            instr_prompts=ds_cfg.get("instr_prompts"),
        )
    elif name in ("vqa", "vizwiz_vqa"):
        if name == "vizwiz_vqa":
            ds = VizWizVQADataset(
                ds_cfg["annt_file"], ds_cfg["data_root"], transform,
                total_length=total,
            )
        else:
            ds = VQADataset(
                ds_cfg["questions_file"], ds_cfg.get("annotations_file"),
                ds_cfg["data_root"], transform,
                image_name_format=ds_cfg.get("image_name_format"),
                total_length=total,
            )
        coll = VQACollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 320),
            instr_prompts=ds_cfg.get("instr_prompts"),
        )
        mode = "generate_vqa"
    elif name == "image_text_jsonl":
        ds = ImageTextJsonlDataset(
            ds_cfg["annt_file"], ds_cfg["data_root"], transform,
            total_length=total,
        )
        coll = ImageTextPairCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 256), mode=mode,
        )
    elif name == "visdial":
        ds = VisDialDenseDataset(
            ds_cfg["dialogs_file"], ds_cfg["dense_file"],
            ds_cfg["data_root"], transform, total_length=total,
        )
        coll = VisDialCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            ctx_len=ds_cfg.get("seq_len", 512),
        )
        mode = "generate_scores"
    elif name == "grounding":
        ds = GroundingDataset(
            ds_cfg["annt_file"], ds_cfg["data_root"], transform,
            total_length=total,
        )
        coll = GroundingCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 256),
        )
        mode = "generate_grounding"
    elif name == "story":
        ds = StoryDataset(
            ds_cfg["annt_file"], ds_cfg["data_root"], transform,
            task_prefix=ds_cfg.get("task_prefix", ""), total_length=total,
        )
        coll = StoryCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 1024),
            max_num_images=model_cfg.max_num_images,
        )
        mode = "generate_storytelling"
    elif name in BENCH_TYPES:
        return _bench_dataset(name, ds_cfg, model_cfg, tokenizer, transform)
    else:
        raise ValueError(name)
    return ds, coll, mode


def _bench_dataset(name, ds_cfg, model_cfg, tokenizer, transform):
    """``(dataset, collator, mode)`` of a `BENCH_TYPES` stanza
    (`evaluate.py:170-276` of the JAX entry)."""
    from .data import datasets_bench as DB
    from .data.collators import ImageTextPairCollator
    from .data.collators_extra import MultiImageCollator, StoryCollator

    total = ds_cfg.get("total_length")
    ntok = model_cfg.num_img_token
    if name in ("nocaps", "flickr30k", "image2paragraph"):
        if name == "image2paragraph":
            ds = DB.Image2ParagraphDataset(
                ds_cfg["annt_root"], ds_cfg["data_root"], transform,
                phase=ds_cfg.get("phase", "test"), total_length=total,
            )
        else:
            cls = (DB.NoCapsDataset if name == "nocaps"
                   else DB.Flickr30KDataset)
            ds = cls(ds_cfg["annt_file"], ds_cfg["data_root"], transform,
                     total_length=total)
        coll = ImageTextPairCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 256), mode="generate_texts",
            instr_prompts=ds_cfg.get("instr_prompts"),
        )
        return ds, coll, "generate_texts"
    if name == "lncoco":
        ds = DB.LNCOCODataset(
            ds_cfg["annt_root"], ds_cfg["data_root"], transform,
            total_length=total, image_only=ds_cfg.get("image_only", False),
        )
        coll = ImageTextPairCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 256), mode="generate_images",
        )
        return ds, coll, "generate_images"
    collate_mode = ds_cfg.get("collate_mode", "generate_images")
    context_type = ds_cfg.get("context_type", "multi_modal")
    if name == "vist":
        ds = DB.VISTDataset(
            ds_cfg["data_root"], ds_cfg["annt_root"], transform,
            phase=ds_cfg.get("phase", "val"), collate_mode=collate_mode,
            round_range=ds_cfg.get("round_range", "last"),
            context_type=context_type, total_length=total,
        )
    elif name in ("pororo", "flintstones"):
        cls = DB.PororoDataset if name == "pororo" else DB.FlintStonesDataset
        ds = cls(ds_cfg["data_root"], ds_cfg["annt_root"], transform,
                 phase=ds_cfg.get("phase", "test"),
                 context_type=context_type, total_length=total)
    else:  # ade20k
        ds = DB.ADE20kDataset(
            ds_cfg["data_root"], ds_cfg["annt_root"], transform,
            phase=ds_cfg.get("phase", "validation"), total_length=total,
        )
    if name == "vist" and collate_mode == "generate_texts":
        coll = MultiImageCollator(
            tokenizer, tokenizer.special, num_img_token=ntok,
            seq_len=ds_cfg.get("seq_len", 1024),
            max_num_images=model_cfg.max_num_images, mode="generate",
        )
        return ds, coll, "generate_texts"
    coll = StoryCollator(
        tokenizer, tokenizer.special, num_img_token=ntok,
        seq_len=ds_cfg.get("seq_len", 1024),
        max_num_images=model_cfg.max_num_images,
    )
    return ds, coll, ("generate_segm" if name == "ade20k"
                      else "generate_storytelling")


def clip_feature_fns(path: str, device):
    """``(image_fn, text_fn)`` of the HF CLIP directory ``path`` for the
    t2i rerank: the projected image features of its vision tower and the
    text features of its text tower, both in fp32 on ``device``
    (counterpart of `evaluate.py:279-325`, whose image side this replaces:
    see ROADMAP.md §3)."""
    try:
        from transformers import CLIPTokenizer
    except ImportError as e:
        raise ImportError("evaluation.clip_text_path: the CLIP tokenizer "
                          "comes from the transformers package, which is "
                          "not installed") from e
    import json
    import os

    import torch

    from .models.clip_text import load_clip
    from .utils.fid import CLIPViTFeatures
    from .utils.state_dict_io import load_torch_state_dict

    heads = (None, None)
    conf = os.path.join(path, "config.json")
    if os.path.isfile(conf):
        with open(conf) as f:
            c = json.load(f)
        heads = tuple((c.get(k) or {}).get("num_attention_heads")
                      for k in ("text_config", "vision_config"))
    tok = CLIPTokenizer.from_pretrained(path)
    text, vision = load_clip(load_torch_state_dict(path), device, heads=heads,
                             eos_token_id=tok.eos_token_id)

    @torch.inference_mode()
    def text_features(captions) -> np.ndarray:
        ids = tok(list(captions), padding="max_length", truncation=True,
                  max_length=text.cfg.max_position_embeddings,
                  return_tensors="np")["input_ids"]
        _, feats = text(torch.from_numpy(ids).long().to(device))
        return feats.float().cpu().numpy()

    return CLIPViTFeatures(vision, projected=True), text_features


def main(argv=None, model=None) -> Dict[str, Any]:
    """Run the evaluation entry point; returns each route's result by
    dataset name.  ``model`` reuses a model built from the config's
    ``model:`` section."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .data.datasets import iterate_dataset
    from .data.tokenizer import load_tokenizer
    from .engine.evaluator import EvalConfig, Evaluator
    from .parallel.inference import (build_generation_runtime, check_runtime,
                                     init_distributed)
    from .utils.checkpoint import entry_model
    from .utils.config import build_model_config, load_config
    from .utils.device import resolve_device

    cfg = load_config(args.config)
    output_dir = args.output_dir or cfg.get("output_dir", "OUTPUT/eval")
    ev_cfg = cfg.get("evaluation", {}) or {}
    device = init_distributed(resolve_device(args.device))
    check_runtime(cfg.get("mesh"), ev_cfg.get("quantize"))
    model_cfg = build_model_config(cfg["model"])
    val = (cfg.get("data", {}) or {}).get("val", []) or []
    tokenizer = load_tokenizer(
        (cfg.get("data", {}) or {}).get("tokenizer_path"),
        vocab_size=model_cfg.llm.vocab_size, special=model_cfg.special)
    # every stanza's dataset is built before the model: a refused type
    # fails before any weight is made
    built = [build_eval_dataset(ds_cfg, model_cfg, tokenizer)
             for ds_cfg in val]
    model = entry_model(model_cfg, device, args.checkpoint, model)
    runtime = build_generation_runtime(model, cfg.get("mesh"),
                                       quantize=ev_cfg.get("quantize"))
    base_eval_cfg = EvalConfig(
        batch_size=ev_cfg.get("batch_size", 8),
        max_new_tokens=ev_cfg.get("max_new_tokens", 30),
        num_beams=ev_cfg.get("num_beams", 1),
        repetition_penalty=ev_cfg.get("repetition_penalty", 1.0),
        length_penalty=ev_cfg.get("length_penalty", 1.0),
        top_p=ev_cfg.get("top_p", 0.9),
        num_inference_steps=ev_cfg.get("num_inference_steps", 30),
        guidance_scale=ev_cfg.get("guidance_scale", 3.5),
        num_candidates=ev_cfg.get("num_candidates", 1),
        output_dir=output_dir,
        max_batches=ev_cfg.get("max_batches"),
    )
    evaluator = Evaluator(model, tokenizer, base_eval_cfg, runtime=runtime)

    # CLIP-FID features from the model's own CLIP ViT
    feature_fn = None
    if ev_cfg.get("clip_fid", False):
        from .utils.fid import CLIPViTFeatures

        feature_fn = CLIPViTFeatures(model.visual_tokenizer.encoder)

    rerank_fn = None  # built at the first stanza that reranks
    results = {}
    for ds_cfg, (ds, coll, mode) in zip(val, built):
        evaluator.cfg = resolve_eval_config(
            base_eval_cfg, mode, ds_cfg, explicit_global=set(ev_cfg),
        )
        batches = iterate_dataset(ds, evaluator.cfg.batch_size, coll)
        name = ds_cfg.get("dataset_name", ds_cfg["type"])
        if mode == "generate_texts":
            result = evaluator.evaluate_caption(
                batches, ds.references(), dataset_name=name)
        elif mode == "generate_vqa":
            result = evaluator.evaluate_vqa(batches, dataset_name=name)
        elif mode == "generate_images":
            # without a CLIP directory the first candidate is kept, as in
            # the JAX entry
            rerank = None
            if ds_cfg.get("rerank_by_clip") and ev_cfg.get("clip_text_path"):
                if rerank_fn is None:
                    from .utils.fid import make_clip_rerank_fn

                    rerank_fn = make_clip_rerank_fn(*clip_feature_fns(
                        ev_cfg["clip_text_path"], device))
                rerank = rerank_fn
            result = evaluator.evaluate_t2i(
                batches, dataset_name=name, feature_fn=feature_fn,
                rerank_fn=rerank)
        elif mode == "generate_scores":
            result = evaluator.evaluate_ranking(batches, dataset_name=name)
        elif mode == "generate_grounding":
            result = evaluator.evaluate_grounding(batches, dataset_name=name)
        elif mode == "generate_storytelling":
            result = evaluator.evaluate_storytelling(
                batches, dataset_name=name, feature_fn=feature_fn)
        elif mode == "generate_segm":
            # the ground-truth class maps; no segmenter, as in the JAX
            # entry (`num_generated` only)
            from PIL import Image

            gt = {i: np.asarray(Image.open(ds.gt_id_to_path(i)))
                  for i in range(len(ds))}
            result = evaluator.evaluate_segm2img(
                batches, gt, segment_fn=None, dataset_name=name)
        else:
            raise ValueError(mode)
        print(f"[{name}] {result}", flush=True)
        results[name] = result
    return results


if __name__ == "__main__":
    main()
