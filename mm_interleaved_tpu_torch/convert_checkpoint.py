"""Assemble the port's full checkpoint from released torch weights
(counterpart of `scripts/convert_checkpoint.py`).

Two modes, as in the JAX script:

1) **The released MM-Interleaved checkpoint** (the full model state dict):

       python -m mm_interleaved_tpu_torch.convert_checkpoint --preset flagship \
           --ref-checkpoint /path/to/mm_interleaved_ckpt/ --out OUTPUT/ckpt.pt

   Every parameter of the port's model is filled through
   `utils.convert_ref.convert_mm_interleaved`; a parameter no source key
   fills, or a source key no entry reads (but for the fixed buffers it
   skips), raises.

2) **Tower assembly** (the day-0 pretrain init):

       python -m mm_interleaved_tpu_torch.convert_checkpoint --preset flagship \
           --llm assets/vicuna-13b --clip assets/clip-vit-large-patch14 \
           --sd assets/stable-diffusion-2-1-base --out OUTPUT/ckpt.pt

   Each tower's HF checkpoint fills its part (the vocabulary padded with
   the mean embedding, the TextDecoder built from ``lm_head``); every other
   parameter keeps the seeded init of `build_model` (``--seed``), as the
   reference trains the adapter, MMFS and perceivers from scratch.

The weights stream from the memory-mapped source into the model's
parameters on ``--device`` (the card unless ``--device cpu``), one tensor
at a time, in ``--dtype``; the output is one file of the port's full
checkpoint format (`utils.checkpoint.save_full_checkpoint`), which
`load_model` (``--checkpoint`` of the inference and evaluation entry
points) and ``--load_from`` of the training entry point read.  The model
is the preset's, with the ``model:`` overrides of ``--config`` when given.
Prints one JSON line: the bytes read, the seconds of the stream and of the
save, the process's host RSS after the model's build and its peak over
the whole conversion (sampled).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from .utils.checkpoint import save_full_checkpoint
from .utils.config import build_model_config, config_to_json, load_config
from .utils.convert_hf import (CLIP_VISION_SKIPS, LLAMA_SKIPS, convert_clip_vit,
                               convert_llama, convert_text_decoder,
                               padded_embedding)
from .utils.convert_ref import REF_SKIPS, convert_mm_interleaved
from .utils.convert_sd import convert_sd_unet, convert_sd_vae
from .utils.device import resolve_device
from .utils.name_map import NameMap, check_coverage, prefixed, stream_into
from .utils.state_dict_io import load_torch_state_dict, strip_prefix

# (source, its name map, the skip patterns of its coverage check)
Part = Tuple[object, NameMap, Tuple[str, ...]]


def ref_parts(path: str, cfg, shapes) -> List[Part]:
    """The released checkpoint's one part: every parameter."""
    sd = strip_prefix(load_torch_state_dict(path))
    return [(sd, convert_mm_interleaved(cfg, shapes.__contains__), REF_SKIPS)]


def _prefix_of(sd, prefix: str) -> str:
    return prefix if any(k.startswith(prefix) for k in sd) else ""


def llm_map(cfg, prefix: str = "model.", rows: Optional[int] = None,
            lm_head_rows: Optional[int] = None) -> NameMap:
    """An HF LLaMA of ``rows`` embedding rows (the original vocabulary by
    default) -> the LLM, its vocabulary padded with the mean embedding; with
    ``lm_head_rows``, also the TextDecoder built from its ``lm_head``."""
    llm = convert_llama(cfg.llm.num_hidden_layers, prefix=prefix)
    llm["embed_tokens.weight"] = padded_embedding(
        f"{prefix}embed_tokens.weight", cfg.llm.vocab_size,
        rows or cfg.orig_vocab_size)
    nmap = prefixed("mm_decoder.", llm)
    if lm_head_rows is not None:
        nmap.update(prefixed("text_decoder.", convert_text_decoder(
            cfg.llm.vocab_size, cfg.orig_vocab_size, cfg.llm.hidden_size,
            lm_head_rows=lm_head_rows)))
    return nmap


def clip_map(cfg, prefix: str = "vision_model.") -> NameMap:
    """An HF CLIP vision tower -> the visual tokenizer's ViT core."""
    return prefixed("visual_tokenizer.encoder.", convert_clip_vit(
        cfg.visual.encoder.vit.num_hidden_layers, prefix=prefix))


def sd_maps(cfg, shapes) -> Dict[str, NameMap]:
    """diffusers ``unet`` and ``vae`` -> the image decoder's."""
    d = cfg.image_decoder
    if d is None:
        raise ValueError("--sd given for a config without an image decoder")
    out = {}
    for sub, fn, c in (("unet", convert_sd_unet, d.unet),
                       ("vae", convert_sd_vae, d.vae)):
        root = f"image_decoder.{sub}."
        out[sub] = prefixed(root, fn(len(c.block_out_channels),
                                     c.layers_per_block,
                                     lambda n, r=root: (r + n) in shapes))
    return out


def tower_parts(args, cfg, shapes) -> List[Part]:
    """The parts of each tower given: the LLM (and the TextDecoder from its
    ``lm_head``), the CLIP vision tower, the SD UNet and VAE."""
    parts: List[Part] = []
    if args.llm:
        sd = load_torch_state_dict(args.llm)
        prefix = _prefix_of(sd, "model.")
        head = "lm_head.weight"
        parts.append((sd, llm_map(
            cfg, prefix, sd.shape(f"{prefix}embed_tokens.weight")[0],
            sd.shape(head)[0] if head in sd else None), LLAMA_SKIPS))
    if args.clip:
        sd = load_torch_state_dict(args.clip)
        parts.append((sd, clip_map(cfg, _prefix_of(sd, "vision_model.")),
                      CLIP_VISION_SKIPS))
    if args.sd:
        for sub, nmap in sd_maps(cfg, shapes).items():
            parts.append((load_torch_state_dict(os.path.join(args.sd, sub)),
                          nmap, ()))
    if not parts:
        raise ValueError("nothing to convert: pass --ref-checkpoint or towers")
    return parts


def convert(args) -> Dict[str, object]:
    """Run the conversion of ``args``; returns the measures."""
    if args.config:
        cfg = build_model_config(dict(load_config(args.config)["model"],
                                      **({"preset": args.preset}
                                         if args.preset else {})))
    else:
        cfg = build_model_config({"preset": args.preset or "flagship"})
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    with RssSampler() as rss:
        res = _convert(args, cfg, device, dtype, rss)
    res["peak_rss_gb"] = rss.peak
    return res


def _convert(args, cfg, device, dtype, rss) -> Dict[str, object]:
    from .models.mm_interleaved import allocate_model, build_model

    t0 = time.perf_counter()
    if args.ref_checkpoint:
        model = allocate_model(cfg, device, dtype)
    else:
        model = build_model(cfg, device, dtype, seed=args.seed)
    params = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    parts = (ref_parts(args.ref_checkpoint, cfg, shapes)
             if args.ref_checkpoint else tower_parts(args, cfg, shapes))
    for sd, nmap, skips in parts:
        check_coverage(nmap, sd.keys(), shapes, skips,
                       full=bool(args.ref_checkpoint))
    if device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rss_built = rss.read()
    t0 = time.perf_counter()
    nbytes = sum(stream_into(params, nmap, sd) for sd, nmap, _ in parts)
    if device.type == "cuda":
        torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_bytes = save_full_checkpoint(
        model, args.out, config=config_to_json(cfg),
        source="ref" if args.ref_checkpoint else "towers", seed=args.seed)
    save_s = time.perf_counter() - t0
    return dict(out=args.out, params=sum(p.numel() for p in params.values()),
                converted=sum(len(nmap) for _, nmap, _ in parts),
                source_bytes=nbytes, stream_s=stream_s,
                stream_gb_per_s=nbytes / stream_s / 1e9, build_s=build_s,
                out_bytes=out_bytes, save_s=save_s, rss_built_gb=rss_built)


class RssSampler:
    """This process's resident set (``VmRSS`` of ``/proc/self/status``),
    sampled every ``period`` seconds by a thread while the ``with`` block
    runs; ``peak`` is the largest sample.  (``getrusage``'s peak does not
    serve: a process started by ``fork`` from a large one keeps the
    parent's resident set as its peak through ``exec``; nor does
    ``VmHWM``, the exact peak, which some sandboxed kernels leave out of
    ``/proc/self/status`` while they report ``VmRSS``.)"""

    def __init__(self, period: float = 0.005):
        self.period = period
        self.peak = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def read() -> float:
        """The resident set now, GB."""
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
        raise RuntimeError("no VmRSS in /proc/self/status")

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, self.read())

    def __enter__(self) -> "RssSampler":
        self.peak = self.read()
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self.read())


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default=None,
                    choices=("tiny", "small", "base", "flagship"),
                    help="the model preset (default: the config's, else "
                    "flagship)")
    ap.add_argument("--config", default=None,
                    help="a YAML whose model: section (preset, overrides) "
                    "gives the model")
    ap.add_argument("--out", required=True)
    ap.add_argument("--ref-checkpoint", default=None,
                    help="released MM-Interleaved checkpoint (file or dir)")
    ap.add_argument("--llm", default=None, help="HF LLaMA/vicuna dir")
    ap.add_argument("--clip", default=None, help="HF CLIP (vision) dir")
    ap.add_argument("--sd", default=None,
                    help="SD dir with unet/ + vae/ subfolders")
    ap.add_argument("--seed", type=int, default=0,
                    help="the init of what the towers do not fill")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ref_checkpoint and (args.llm or args.clip or args.sd):
        raise ValueError("--ref-checkpoint and the towers are two modes")
    res = convert(args)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
