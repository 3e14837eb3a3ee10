"""Checkpoints on disk for the converter tests (tests/test_torch_convert*.py):
tiny HF towers written by transformers (LLaMA, CLIP vision) and by the
`safetensors` package (the diffusers-named mini UNet and VAE of
`_reference_sd.py`), and a seeded reference-format checkpoint written by the
port's own writer from the converter's name map."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu_torch.utils import convert_ref, name_map
from mm_interleaved_tpu_torch.utils.state_dict_io import write_sharded

from _reference_sd import TorchMiniUNet, TorchMiniVAE

# the fixed buffers a released checkpoint holds beside the parameters
REF_BUFFERS = {"visual_tokenizer.pos_embed": (1, 16, 32),
               "visual_tokenizer.clip_mean": (1, 1, 1, 3),
               "visual_tokenizer.clip_std": (1, 1, 1, 3),
               "image_decoder.decoder.mmfs_module.mmfs_down_blocks.0.pos_embed":
                   (1, 16, 32)}


def _noised(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def write_hf_towers(root: str, seed: int = 0):
    """``(llm_dir, clip_dir, sd_dir, hf_llm)`` at the tiny preset's widths:
    an HF LlamaForCausalLM of 120 rows (the tiny vocabulary is 128), an HF
    CLIPVisionModel, diffusers-named unet/ and vae/."""
    from safetensors.torch import save_file
    from transformers import (CLIPVisionConfig, CLIPVisionModel, LlamaConfig,
                              LlamaForCausalLM)

    torch.manual_seed(seed)
    llm = _noised(LlamaForCausalLM(LlamaConfig(
        vocab_size=120, hidden_size=32, intermediate_size=64,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        attn_implementation="eager")), seed + 1).eval()
    llm_dir = os.path.join(root, "llm")
    llm.save_pretrained(llm_dir, safe_serialization=True)
    clip = _noised(CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, image_size=56, patch_size=14)), seed + 2)
    clip_dir = os.path.join(root, "clip")
    clip.save_pretrained(clip_dir, safe_serialization=True)
    sd_dir = os.path.join(root, "sd")
    for sub, model in (("unet", TorchMiniUNet()), ("vae", TorchMiniVAE())):
        os.makedirs(os.path.join(sd_dir, sub))
        save_file({k: v.contiguous() for k, v in
                   _noised(model, seed + 3).state_dict().items()},
                  os.path.join(sd_dir, sub,
                               "diffusion_pytorch_model.safetensors"))
    return llm_dir, clip_dir, sd_dir, llm


def ref_source(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded reference-format state dict for ``cfg``: the keys and shapes
    of the converter's name map, and the fixed buffers it skips."""
    with torch.device("meta"):
        model = MMInterleaved(cfg)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    nmap = convert_ref.convert_mm_interleaved(cfg, shapes.__contains__)
    specs = dict(name_map.source_specs(nmap, shapes), **REF_BUFFERS)
    rs = np.random.RandomState(seed)
    return {k: (0.3 * rs.randn(*s)).astype(np.float32)
            for k, s in specs.items()}


def write_ref_checkpoint(out_dir: str, sd: Dict[str, np.ndarray],
                         dtype=torch.float32, shards: int = 2):
    """``sd`` as sharded safetensors under ``out_dir`` (the port's writer)."""
    specs = [(k, v.shape, dtype) for k, v in sd.items()]
    return write_sharded(out_dir, specs,
                         lambda k: torch.from_numpy(sd[k]).to(dtype), shards)
