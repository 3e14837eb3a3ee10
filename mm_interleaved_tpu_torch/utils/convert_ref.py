"""The released MM-Interleaved checkpoint -> the port's parameters
(counterpart of `mm_interleaved_tpu/utils/convert_ref.py`).

Maps the *full* reference `MMInterleaved` torch state dict (the Vicuna-13B
``mm_decoder`` with its MMFS layers, the CLIP ViT-Adapter visual tokenizer,
the perceivers, the TextDecoder, the SD-2.1 UNet, VAE and MMFSNet) onto the
port's parameter names.  Torch to torch, so:

  * Linear ``[out, in]``, Conv OIHW (the depthwise ``[C, 1, 3, 3]``) and the
    ConvTranspose ``adapter_up`` ``[in, out, kh, kw]`` carry over as they
    are: the JAX converter transposes and flips for flax, and the port's
    `from_flax` undoes both;
  * the layers stay unrolled (no ``stack_llama_layers``);
  * the fixed sin-cos buffers (``visual_tokenizer.pos_embed``, each MMFS
    block's ``pos_embed``) and ``clip_mean`` / ``clip_std`` are recomputed
    by the port's modules and skipped (`REF_SKIPS`).
"""

from __future__ import annotations

from typing import Callable, Collection

from .convert_hf import convert_clip_vit, convert_llama, convert_mmfs
from .convert_sd import convert_sd_unet, convert_sd_vae
from .name_map import NameMap, flat, prefixed, same, source_prefixed
from .name_map import weight_bias as _wb

REF_SKIPS = (r"(^|\.)pos_embed$", r"(^|\.)clip_(mean|std)$")
MSDA_LINEARS = ("sampling_offsets", "attention_weights", "value_proj",
                "output_proj")


def convert_perceiver(prefix: str, num_layers: int,
                      cross_attention_frequency: int = 2,
                      qk_normalization: bool = False) -> NameMap:
    """Reference `PerceiverResampler` (HF Blip2QFormerModel + queries,
    decoders/perceiver.py:7-30; the qk-norm patch
    blip2_qknorm_monkey_patch.py) -> the port's `PerceiverResampler`."""
    q = f"{prefix}blip2qformer."
    p: NameMap = {"queries": same(f"{prefix}queries")}
    p.update(_wb("input_norm", f"{q}layernorm"))

    def mha(dst: str, src: str) -> NameMap:
        out: NameMap = {}
        for name in ("query", "key", "value"):
            out.update(_wb(f"{dst}.{name}", f"{src}.attention.{name}"))
        out.update(_wb(f"{dst}.output", f"{src}.output.dense"))
        if qk_normalization:
            out.update(_wb(f"{dst}.q_norm", f"{src}.attention.q_norm"))
            out.update(_wb(f"{dst}.k_norm", f"{src}.attention.k_norm"))
        return out

    for i in range(num_layers):
        lp = f"{q}encoder.layer.{i}."
        d = f"layers.{i}."
        p.update(mha(f"{d}attention", f"{lp}attention"))
        p.update(_wb(f"{d}attention_norm", f"{lp}attention.output.LayerNorm"))
        if i % cross_attention_frequency == 0:
            p.update(mha(f"{d}crossattention", f"{lp}crossattention"))
            p.update(_wb(f"{d}crossattention_norm",
                         f"{lp}crossattention.output.LayerNorm"))
        p.update(_wb(f"{d}intermediate", f"{lp}intermediate_query.dense"))
        p.update(_wb(f"{d}ffn_output", f"{lp}output_query.dense"))
        p.update(_wb(f"{d}output_norm", f"{lp}output_query.LayerNorm"))
    return p


def convert_ms_deform_attn(prefix: str) -> NameMap:
    """Deformable-DETR `MSDeformAttn` (encoders/vit_adapter/ops/modules/
    ms_deform_attn.py:28-131) -> the port's `MSDeformAttn`."""
    out: NameMap = {}
    for name in MSDA_LINEARS:
        out.update(_wb(name, f"{prefix}{name}"))
    return out


def convert_spm(prefix: str) -> NameMap:
    """SpatialPriorModule (adapter_modules.py:267-328): the stem's
    Sequential indices 0/3/6 are convolutions without bias, 1/4/7
    LayerNorms; conv2..4 are (conv, LN); fc1..4 1x1 convolutions."""
    p: NameMap = {}
    pairs = [(f"stem.{c}", f"stem.{n}") for c, n in ((0, 1), (3, 4), (6, 7))]
    pairs += [(f"{name}.0", f"{name}.1") for name in ("conv2", "conv3", "conv4")]
    for i, (conv, norm) in enumerate(pairs):
        p.update(_wb(f"convs.{i}.conv", f"{prefix}{conv}", bias=False))
        p.update(_wb(f"convs.{i}.norm", f"{prefix}{norm}"))
    for name in ("fc1", "fc2", "fc3", "fc4"):
        p.update(_wb(name, f"{prefix}{name}"))
    return p


def _injector(prefix: str) -> NameMap:
    p = _wb("query_norm", f"{prefix}query_norm")
    p.update(_wb("feat_norm", f"{prefix}feat_norm"))
    p.update(prefixed("attn.", convert_ms_deform_attn(f"{prefix}attn.")))
    p["gamma"] = same(f"{prefix}gamma")
    return p


def _extractor(prefix: str) -> NameMap:
    p = _wb("query_norm", f"{prefix}query_norm")
    p.update(_wb("feat_norm", f"{prefix}feat_norm"))
    p.update(prefixed("attn.", convert_ms_deform_attn(f"{prefix}attn.")))
    p.update(_wb("ffn_norm", f"{prefix}ffn_norm"))
    p.update(_wb("ffn.fc1", f"{prefix}ffn.fc1"))
    p.update(_wb("ffn.dwconv", f"{prefix}ffn.dwconv.dwconv"))
    p.update(_wb("ffn.fc2", f"{prefix}ffn.fc2"))
    return p


def convert_vit_adapter(prefix: str, num_vit_layers: int = 24,
                        num_interactions: int = 4,
                        extra_extractors: int = 2) -> NameMap:
    """`CLIPVisionTransformerAdapter` (vit_adapter_hf.py:37-171) -> the
    port's `CLIPViTAdapter` (the ViT core, the SPM, the interaction blocks,
    ``adapter_up``)."""
    p = convert_clip_vit(num_vit_layers, prefix=prefix)
    p["adapter_level_embed"] = same(f"{prefix}adapter_level_embed")
    p.update(prefixed("adapter_spm.", convert_spm(f"{prefix}adapter_spm.")))
    for gi in range(num_interactions):
        ip = f"{prefix}adapter_interactions.{gi}."
        p.update(prefixed(f"injectors.{gi}.", _injector(f"{ip}injector.")))
        p.update(prefixed(f"extractors.{gi}.", _extractor(f"{ip}extractor.")))
    last = f"{prefix}adapter_interactions.{num_interactions - 1}."
    for ei in range(extra_extractors):
        p.update(prefixed(f"extra_extractors.{ei}.",
                          _extractor(f"{last}extra_extractors.{ei}.")))
    p.update(_wb("adapter_up", f"{prefix}adapter_up"))
    return p


def convert_visual_tokenizer(prefix: str = "visual_tokenizer.",
                             num_vit_layers: int = 24,
                             num_interactions: int = 4,
                             extra_extractors: int = 2,
                             perceiver_layers: int = 12,
                             qk_normalization: bool = True) -> NameMap:
    """Reference `VisualTokenizer` (encoders/visual_tokenizer.py:11-101)."""
    p = prefixed("encoder.", convert_vit_adapter(
        f"{prefix}encoder.vision_model.", num_vit_layers, num_interactions,
        extra_extractors))
    for name in ("pos_proj", "pos_ln", "post_ln", "proj"):
        p.update(_wb(name, f"{prefix}{name}"))
    p.update(prefixed("perceiver_resampler.", convert_perceiver(
        f"{prefix}perceiver_resampler.", perceiver_layers,
        cross_attention_frequency=2, qk_normalization=qk_normalization)))
    return p


def convert_mmfs_block(prefix: str) -> NameMap:
    """UNet-side MMFSBlock (decoders/sd_mmfs.py:44-151) -> the port's
    (query_norm, feat_norm, mmfs, conv; the fixed pos_embed is skipped)."""
    p = _wb("query_norm", f"{prefix}query_norm")
    p.update(_wb("feat_norm", f"{prefix}feat_norm"))
    p.update(prefixed("mmfs.", convert_mmfs(f"{prefix}mmfs.")))
    p.update(_wb("conv", f"{prefix}conv"))
    return p


def convert_mmfs_net(prefix: str, num_down_blocks: int = 13) -> NameMap:
    """MMFSNet (sd_mmfs.py:154-272): one block per UNet down residual, and
    the mid block."""
    p: NameMap = {}
    for i in range(num_down_blocks):
        p.update(prefixed(f"down_blocks_{i}.", convert_mmfs_block(
            f"{prefix}mmfs_down_blocks.{i}.")))
    p.update(prefixed("mid_block.", convert_mmfs_block(
        f"{prefix}mmfs_mid_block.")))
    return p


def convert_image_decoder(has: Callable[[str], bool],
                          prefix: str = "image_decoder.",
                          n_unet_blocks: int = 4,
                          unet_layers_per_block: int = 2,
                          n_vae_blocks: int = 4,
                          vae_layers_per_block: int = 2,
                          perceiver_layers: int = 1) -> NameMap:
    """Reference `ImageDecoder` (decoders/decoder_image.py:9-156) with the
    SD wrapper's unet, vae and mmfs_module (decoders/sd.py:24-120);
    ``has(name)`` says whether the port's image decoder has ``name``."""
    dec = f"{prefix}decoder."
    unet = source_prefixed(f"{dec}unet.", convert_sd_unet(
        n_unet_blocks, unet_layers_per_block, lambda n: has(f"unet.{n}")))
    n_down = 1 + n_unet_blocks * unet_layers_per_block + (n_unet_blocks - 1)
    unet.update(prefixed("mmfs_net.", convert_mmfs_net(
        f"{dec}mmfs_module.", num_down_blocks=n_down)))
    p = prefixed("perceiver_resampler.", convert_perceiver(
        f"{prefix}perceiver_resampler.", perceiver_layers,
        cross_attention_frequency=1))
    p["neg_prompt_embeds"] = same(f"{prefix}neg_prompt_embeds")
    p.update(prefixed("unet.", unet))
    p.update(prefixed("vae.", source_prefixed(f"{dec}vae.", convert_sd_vae(
        n_vae_blocks, vae_layers_per_block, lambda n: has(f"vae.{n}")))))
    return p


def convert_mm_interleaved(cfg, has: Callable[[str], bool]) -> NameMap:
    """Full reference `MMInterleaved` state dict -> every parameter of the
    port's model of config ``cfg``; ``has(name)`` says whether the port's
    model has the parameter ``name`` (its MMFS layers, its resnet
    shortcuts, its image decoder)."""
    c = cfg
    n = c.llm.num_hidden_layers
    mmfs: Collection[int] = [i for i in range(n) if has(
        f"mm_decoder.layers.{i}.llama_cross_attn.gate")]
    p = prefixed("mm_decoder.", convert_llama(n, "mm_decoder.model.", mmfs))
    p["soi_token"] = flat("soi_token", 2)
    p.update(_wb("context_feat_proj", "context_feat_proj"))
    p.update(prefixed("visual_tokenizer.", convert_visual_tokenizer(
        num_vit_layers=c.visual.encoder.vit.num_hidden_layers,
        num_interactions=c.visual.encoder.num_interactions,
        extra_extractors=c.visual.encoder.extra_extractors,
        perceiver_layers=c.visual.perceiver.num_hidden_layers,
        qk_normalization=c.visual.perceiver.qk_normalization)))
    p.update(_wb("text_decoder.head", "text_decoder.head"))
    p.update(_wb("text_decoder.head_new", "text_decoder.head_new"))
    if c.image_decoder is not None:
        d = c.image_decoder
        p.update(prefixed("image_decoder.", convert_image_decoder(
            lambda x: has(f"image_decoder.{x}"),
            n_unet_blocks=len(d.unet.block_out_channels),
            unet_layers_per_block=d.unet.layers_per_block,
            n_vae_blocks=len(d.vae.block_out_channels),
            vae_layers_per_block=d.vae.layers_per_block,
            perceiver_layers=d.perceiver.num_hidden_layers)))
    return p
