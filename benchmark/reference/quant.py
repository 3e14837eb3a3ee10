"""The int8 deployment's weights, worked out again from the bf16 weights:
symmetric absmax int8 per output row of each LLM projection, dequantized
in float32 (the arithmetic of the program's weight-only int8, copied)."""

from __future__ import annotations

from typing import Set

import torch
from torch import nn

LLM_PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj", "head", "head_new")
LLM_ROOTS = ("mm_decoder", "text_decoder", "layers")


def is_quant_name(name: str) -> bool:
    parts = name.split(".")
    return (len(parts) >= 2 and parts[-1] in LLM_PROJ_NAMES
            and parts[0] in LLM_ROOTS)


def quantized_weights(model: nn.Module) -> Set[str]:
    """The weight names of the Linear layers the deployment quantizes."""
    return {f"{n}.weight" for n, m in model.named_modules()
            if is_quant_name(n) and isinstance(m, nn.Linear)}


def roundtrip(w: torch.Tensor, levels: int) -> torch.Tensor:
    """Symmetric absmax rounding of ``w [out, in]`` to ``levels`` steps a
    side per output row, dequantized in float32."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1).clamp_min(1e-8) / levels
    q = torch.round(wf / scale[..., None]).clamp_(-levels, levels)
    return q * scale[..., None]


def int8_roundtrip(w: torch.Tensor) -> torch.Tensor:
    return roundtrip(w, 127)


def int4_roundtrip(w: torch.Tensor) -> torch.Tensor:
    return roundtrip(w, 7)


def fp8_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one float32 scale an output row
    (its absmax to e4m3's largest finite 448), back in float32."""
    wf = w.float()
    if wf.dim() < 2:
        return wf
    flat = wf.reshape(wf.shape[0], -1)
    scale = flat.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    q = (flat / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).reshape(wf.shape)
