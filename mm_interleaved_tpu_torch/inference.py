"""Interleaved multi-turn inference entry point of the PyTorch port
(counterpart of `inference.py`).

    python -m mm_interleaved_tpu_torch.inference --config configs/inference.yaml \
        --annt_path annt.json [--image_root DIR] [--checkpoint CKPT] \
        [--output_dir OUT] [--device cuda|cpu]

Loads annt.json, runs the text/image turns of `inference_loop` on each
sample, writes each generated image as ``sample{i}_img{j}.png`` and the
texts to ``eval_results_<time>.json``.  The model is the seeded one of the
config, or ``--checkpoint``: a full checkpoint (``python -m
mm_interleaved_tpu_torch.convert_checkpoint`` writes one from the released
weights) or a checkpoint of the port's `Trainer` (`utils.checkpoint`).

``inference.quantize: int8`` runs the LLM with int8 weights (`ops.quant`).
Runs on the card; ``--device cpu`` runs on the CPU.  A ``mesh:`` over more
than one device (ROADMAP.md §1 item 6) and an orbax checkpoint directory
are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
from PIL import Image

from .data.tokenizer import load_tokenizer
from .inference_loop import InferenceConfig, InterleavedInferencePipeline
from .parallel.inference import build_generation_runtime, check_runtime
from .utils.checkpoint import entry_model
from .utils.config import build_model_config, load_config
from .utils.device import resolve_device


def main(argv=None, model=None) -> Dict[str, Any]:
    """Run the inference entry point; returns the per-sample results, the
    image paths and the results file.  ``model`` reuses a model built from
    the config's ``model:`` section."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--annt_path", required=True)
    ap.add_argument("--image_root", default="")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--output_dir", default="OUTPUT/inference")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    inf = cfg.get("inference", {}) or {}
    check_runtime(cfg.get("mesh"), inf.get("quantize"))
    device = resolve_device(args.device)
    model_cfg = build_model_config(cfg["model"])
    model = entry_model(model_cfg, device, args.checkpoint, model)
    runtime = build_generation_runtime(model, cfg.get("mesh"),
                                       quantize=inf.get("quantize"))
    tokenizer = load_tokenizer(
        (cfg.get("data", {}) or {}).get("tokenizer_path"),
        vocab_size=model_cfg.llm.vocab_size, special=model_cfg.special)
    pipe = InterleavedInferencePipeline(
        model, tokenizer, runtime=runtime,
        cfg=InferenceConfig(
            num_iter=inf.get("num_iter", 2),
            start_mode=inf.get("start_mode", "generate_texts"),
            max_new_tokens=inf.get("max_new_tokens", 64),
            num_inference_steps=inf.get("num_inference_steps", 30),
            guidance_scale=inf.get("guidance_scale", 3.5),
            force_image_every_turn=inf.get("force_image_every_turn", False),
            seed=inf.get("seed", 0),
        ),
    )

    os.makedirs(args.output_dir, exist_ok=True)
    results, paths = [], []
    for si, sample in enumerate(pipe.load_annt_data(args.annt_path,
                                                    args.image_root)):
        out = pipe.run(sample)
        for ii, img in enumerate(out["images"]):
            path = os.path.join(args.output_dir, f"sample{si}_img{ii}.png")
            Image.fromarray((np.asarray(img) * 255).astype(np.uint8)).save(
                path)
            paths.append(path)
        results.append({"sample": si, "texts": out["texts"],
                        "num_images": len(out["images"])})
        print(f"[{si}] texts={out['texts']} images={len(out['images'])}",
              flush=True)

    ts = time.strftime("%Y%m%d%H%M%S")
    results_file = os.path.join(args.output_dir, f"eval_results_{ts}.json")
    with open(results_file, "w") as f:
        json.dump(results, f, indent=2)
    return dict(results=results, images=paths, results_file=results_file)


if __name__ == "__main__":
    main()
