"""diffusers Stable Diffusion checkpoints -> the port's UNet and VAE
(counterpart of `mm_interleaved_tpu/utils/convert_sd.py`).

Keyed on diffusers' names (`UNet2DConditionModel` with
``use_linear_projection=True`` as in SD2.x, and `AutoencoderKL`).  The
optional tensors of a resnet (``time_emb_proj`` in the UNet,
``conv_shortcut`` where the channels change) are mapped where the port's
module has them; a source that lacks one then fails the coverage check,
one that has an extra one too.  Names are relative to the UNet / VAE.
"""

from __future__ import annotations

from typing import Callable

from .name_map import NameMap, linear_of, prefixed, same
from .name_map import weight_bias as _wb

Has = Callable[[str], bool]


def _resnet(dst: str, src: str, has: Has) -> NameMap:
    out: NameMap = {}
    for name in ("norm1", "conv1", "norm2", "conv2"):
        out.update(_wb(f"{dst}.{name}", f"{src}.{name}"))
    for name in ("time_emb_proj", "conv_shortcut"):
        if has(f"{dst}.{name}.weight"):
            out.update(_wb(f"{dst}.{name}", f"{src}.{name}"))
    return out


def _transformer(dst: str, src: str) -> NameMap:
    tb = f"{src}.transformer_blocks.0"
    out: NameMap = {}
    for name in ("norm1", "norm2", "norm3"):
        out.update(_wb(f"{dst}.block.{name}", f"{tb}.{name}"))
    for a in ("attn1", "attn2"):
        for x in ("q", "k", "v"):
            out.update(_wb(f"{dst}.block.{a}_{x}", f"{tb}.{a}.to_{x}",
                           bias=False))
        out.update(_wb(f"{dst}.block.{a}_out", f"{tb}.{a}.to_out.0"))
    out.update(_wb(f"{dst}.block.ff_in", f"{tb}.ff.net.0.proj"))
    out.update(_wb(f"{dst}.block.ff_out", f"{tb}.ff.net.2"))
    out.update(_wb(f"{dst}.norm", f"{src}.norm"))
    for name in ("proj_in", "proj_out"):
        out[f"{dst}.{name}.weight"] = linear_of(f"{src}.{name}.weight")
        out[f"{dst}.{name}.bias"] = same(f"{src}.{name}.bias")
    return out


def convert_sd_unet(n_blocks: int, layers_per_block: int, has: Has) -> NameMap:
    """diffusers UNet2DConditionModel -> the port's UNet; ``has(name)``
    says whether the port's UNet has the parameter ``name``."""
    p: NameMap = {}
    p.update(_wb("conv_in", "conv_in"))
    p.update(_wb("time_fc1", "time_embedding.linear_1"))
    p.update(_wb("time_fc2", "time_embedding.linear_2"))
    p.update(_wb("conv_norm_out", "conv_norm_out"))
    p.update(_wb("conv_out", "conv_out"))
    p.update(_resnet("mid_res_0", "mid_block.resnets.0", has))
    p.update(_resnet("mid_res_1", "mid_block.resnets.1", has))
    p.update(_transformer("mid_attn", "mid_block.attentions.0"))
    for i in range(n_blocks):
        has_attn = i != n_blocks - 1
        for j in range(layers_per_block):
            p.update(_resnet(f"down_{i}_res_{j}",
                             f"down_blocks.{i}.resnets.{j}", has))
            if has_attn:
                p.update(_transformer(f"down_{i}_attn_{j}",
                                      f"down_blocks.{i}.attentions.{j}"))
        if i != n_blocks - 1:
            p.update(_wb(f"down_{i}_downsample",
                         f"down_blocks.{i}.downsamplers.0.conv"))
    for i in range(n_blocks):
        has_attn = i != 0  # up block i reads level n-1-i; the deepest has none
        for j in range(layers_per_block + 1):
            p.update(_resnet(f"up_{i}_res_{j}", f"up_blocks.{i}.resnets.{j}",
                             has))
            if has_attn:
                p.update(_transformer(f"up_{i}_attn_{j}",
                                      f"up_blocks.{i}.attentions.{j}"))
        if i != n_blocks - 1:
            p.update(_wb(f"up_{i}_upsample",
                         f"up_blocks.{i}.upsamplers.0.conv"))
    return p


def _vae_attn(dst: str, src: str) -> NameMap:
    out = _wb(f"{dst}.group_norm", f"{src}.group_norm")
    for name in ("to_q", "to_k", "to_v"):
        out.update(_wb(f"{dst}.{name}", f"{src}.{name}"))
    out.update(_wb(f"{dst}.to_out", f"{src}.to_out.0"))
    return out


def _vae_half(half: str, n_blocks: int, layers_per_block: int,
              has: Has) -> NameMap:
    enc = half == "encoder"
    h: NameMap = {}
    for name in ("conv_in", "conv_norm_out", "conv_out"):
        h.update(_wb(name, f"{half}.{name}"))
    h.update(_resnet("mid_res_0", f"{half}.mid_block.resnets.0",
                     lambda n: has(f"{half}.{n}")))
    h.update(_resnet("mid_res_1", f"{half}.mid_block.resnets.1",
                     lambda n: has(f"{half}.{n}")))
    h.update(_vae_attn("mid_attn", f"{half}.mid_block.attentions.0"))
    kind, n_res = ("down", layers_per_block) if enc else \
        ("up", layers_per_block + 1)
    for i in range(n_blocks):
        for j in range(n_res):
            h.update(_resnet(f"{kind}_{i}_res_{j}",
                             f"{half}.{kind}_blocks.{i}.resnets.{j}",
                             lambda n: has(f"{half}.{n}")))
        if i != n_blocks - 1:
            sampler = "downsamplers" if enc else "upsamplers"
            h.update(_wb(f"{kind}_{i}_{kind}sample",
                         f"{half}.{kind}_blocks.{i}.{sampler}.0.conv"))
    return prefixed(f"{half}.", h)


def convert_sd_vae(n_blocks: int, layers_per_block: int, has: Has) -> NameMap:
    """diffusers AutoencoderKL -> the port's VAE; ``has(name)`` says
    whether the port's VAE has the parameter ``name``."""
    p = _vae_half("encoder", n_blocks, layers_per_block, has)
    p.update(_vae_half("decoder", n_blocks, layers_per_block, has))
    p.update(_wb("quant_conv", "quant_conv"))
    p.update(_wb("post_quant_conv", "post_quant_conv"))
    return p
