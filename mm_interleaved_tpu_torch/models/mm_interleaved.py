"""MMInterleaved, the top-level interleaved image-text model (counterpart of
`mm_interleaved_tpu/models/mm_interleaved.py`, the generation pieces).

One token stream mixes text with per-image blocks of ``<soi>`` +
``num_img_token`` ``<image>`` placeholders.  The visual tokenizer's query
embeddings are scattered into the stream, and its pyramids are read by the
LLM's MMFS layers and, through the image decoder's UNet, by image
generation: `generate_image_inputs` runs the cache-free prefix forward and
returns each target image's reversed context window and its previous
image's pyramid, for `generation.diffusion.generate_images`.  Images
arrive padded, ``[B, max_img, H, W, 3]`` with ``num_image_per_seq``.
`forward` is the training loss: the next-token cross-entropy plus 10x the
image decoder's diffusion loss.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn
from einops import rearrange

from ..ops.pos_embed import get_1d_sincos_pos_embed
from . import stream_ops as so
from .image_decoder import ImageDecoder, ImageDecoderConfig
from .llama import KVCache, LlamaConfig, LlamaModel, TextDecoder
from .visual_tokenizer import VisualTokenizer, VisualTokenizerConfig


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 31999
    soi_token_id: int = 32000
    image_token_id: int = 32001


@dataclasses.dataclass(frozen=True)
class MMInterleavedConfig:
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    visual: VisualTokenizerConfig = dataclasses.field(
        default_factory=VisualTokenizerConfig
    )
    image_decoder: Optional[ImageDecoderConfig] = None
    special: SpecialTokens = dataclasses.field(default_factory=SpecialTokens)
    seq_len: int = 2048
    num_img_token: int = 64
    max_num_images: int = 10
    max_context_len: int = 512
    loss_img_weight: float = 10.0
    loss_txt_weight: float = 1.0
    orig_vocab_size: int = 32000


class MMInterleaved(nn.Module):
    def __init__(self, cfg: MMInterleavedConfig):
        super().__init__()
        self.cfg = cfg
        self.visual_tokenizer = VisualTokenizer(cfg.visual)
        self.mm_decoder = LlamaModel(cfg.llm)
        self.text_decoder = TextDecoder(cfg.llm,
                                        orig_vocab_size=cfg.orig_vocab_size)
        self.soi_token = nn.Parameter(torch.empty(cfg.llm.hidden_size))
        if cfg.image_decoder is not None:
            # the JAX module creates its params only where it is called:
            # on the image-decoder path
            self.context_feat_proj = nn.Linear(cfg.llm.hidden_size,
                                               cfg.llm.hidden_size)
            self.image_decoder = ImageDecoder(cfg.image_decoder)

    def init_weights(self, g: torch.Generator) -> None:
        self.soi_token.data.zero_()

    def _encode_images(self, image_tensors: torch.Tensor, generator=None):
        """[B, max_img, H, W, 3] -> vis_embed [B, max_img, n_tok, C_llm],
        pyramid levels each [B, max_img, h, w, C_vis]."""
        B = image_tensors.shape[0]
        flat = rearrange(image_tensors, "b n h w c -> (b n) h w c")
        out = self.visual_tokenizer(flat, generator)
        vis_embed = rearrange(out["vis_embed"], "(b n) t c -> b n t c", b=B)
        pyramid = tuple(
            rearrange(f, "(b n) h w c -> b n h w c", b=B)
            for f in out["multiscale_features"]
        )
        return vis_embed, pyramid

    def _mmfs_value_for_llm(self, pyramid) -> torch.Tensor:
        """The pyramid levels of ``llm.spatial_shapes``, flattened to the
        MMFS value layout ``[B, max_img, sum(hw), C]``."""
        shapes = self.cfg.llm.spatial_shapes
        chosen = [rearrange(f, "b n h w c -> b n (h w) c")
                  for f in pyramid if f.shape[2] in shapes]
        if len(chosen) != len(shapes):
            raise ValueError(
                f"pyramid {[tuple(f.shape) for f in pyramid]} lacks the "
                f"levels {shapes}"
            )
        return torch.cat(chosen, dim=2)

    def prepare_mm_embeds(self, text_ids, image_tensors, num_image_per_seq,
                          generator=None):
        c = self.cfg
        max_img = image_tensors.shape[1]
        text_embeds = self.mm_decoder.embed(text_ids)
        vis_embed, pyramid = self._encode_images(image_tensors, generator)
        mm_embeds = so.scatter_image_embeds(
            text_embeds, text_ids, vis_embed, c.special.image_token_id
        )
        mm_embeds = so.add_soi_embeds(
            mm_embeds, text_ids, self.soi_token.to(mm_embeds.dtype),
            c.special.soi_token_id,
        )
        cross_mask, soi_pos = so.mm_cross_attention_mask(
            text_ids, num_image_per_seq, c.special.soi_token_id,
            c.special.bos_token_id, max_img,
        )
        return dict(
            mm_embeds=mm_embeds,
            cross_attention_mask=cross_mask,
            mmfs_values=self._mmfs_value_for_llm(pyramid),
            soi_pos=soi_pos,
            pyramid=pyramid,
        )

    def lm_prefill(self, mm_embeds, attention_mask, mmfs_values,
                   cross_attention_mask, cache: KVCache):
        """Returns ``(logits, hidden, cache, vision_values)``; the last is the
        per-cross-layer MMFS value projection for the decode steps."""
        hidden, cache, vision_values = self.mm_decoder(
            mm_embeds,
            attention_mask=attention_mask,
            vision_hidden_states=mmfs_values,
            cross_attention_mask=cross_attention_mask,
            cache=cache,
        )
        return self.text_decoder(hidden), hidden, cache, vision_values

    def lm_decode_step(self, token_ids, attention_mask, mmfs_values,
                       cross_attention_mask, cache: KVCache,
                       vision_value_cache: Optional[List[torch.Tensor]] = None):
        """One decode step over ``token_ids [B, 1]``; ``vision_value_cache``
        (from `lm_prefill`) skips the value projection of the pyramids."""
        embeds = self.mm_decoder.embed(token_ids)
        embeds = so.add_soi_embeds(
            embeds, token_ids, self.soi_token.to(embeds.dtype),
            self.cfg.special.soi_token_id,
        )
        hidden, cache, _ = self.mm_decoder(
            embeds,
            attention_mask=attention_mask,
            vision_hidden_states=mmfs_values,
            cross_attention_mask=cross_attention_mask,
            cache=cache,
            vision_value_cache=vision_value_cache,
        )
        return self.text_decoder(hidden), cache

    def _image_decoder_inputs(self, hidden, text_ids, soi_pos, pyramid,
                              num_image_per_seq):
        """Context windows and the previous image's pyramid for the image
        decoder: ``(ctx [(b n), max_ctx, C], ctx_mask [(b n), max_ctx],
        mmfs_values [(b n), 1, sum(hw), C_vis], mmfs_mask [(b n), 1])``."""
        c = self.cfg
        B, L, _ = hidden.shape
        near_bos = so.nearest_bos_positions(text_ids, c.special.bos_token_id)
        ctx, ctx_mask = so.context_windows(
            hidden, soi_pos, near_bos, num_image_per_seq,
            min(c.max_context_len, L),
        )
        ctx = self.context_feat_proj(ctx)
        pe = torch.from_numpy(get_1d_sincos_pos_embed(c.llm.hidden_size,
                                                      ctx.shape[2]))
        ctx = ctx + pe.to(ctx.device, ctx.dtype)[None, None]

        prev_mask = so.previous_image_mask(soi_pos, near_bos,
                                           num_image_per_seq, L)
        feats = []
        for feat in pyramid:
            if feat.shape[2] in c.image_decoder.spatial_shapes:
                prev = torch.roll(feat, 1, dims=1)  # image k-1 at slot k
                prev = prev * prev_mask[:, :, None, None, None].to(prev.dtype)
                feats.append(rearrange(prev, "b n h w c -> (b n) 1 (h w) c"))
        mmfs_values = torch.cat(feats, dim=2)
        return (rearrange(ctx, "b n l c -> (b n) l c"),
                rearrange(ctx_mask, "b n l -> (b n) l"),
                mmfs_values,
                rearrange(prev_mask, "b n -> (b n) 1"))

    def forward(self, text_ids, image_tensors, num_image_per_seq,
                attention_mask=None, image_tensors_dec=None,
                image_loss_mask=None, gt_text_ids=None,
                ignore_prompt_token_offset=0,
                ignore_noimage_cond_loss: bool = False,
                generator: Optional[torch.Generator] = None, **draws):
        """The training losses ``{"loss_txt", "loss_img", "loss"}``: the
        cache-free LLM pass, the CE over `stream_ops.prepare_gt_text_ids`
        labels (or ``gt_text_ids[:, 1:]``), and, with the image decoder, its
        loss on ``image_tensors_dec`` (default ``image_tensors``) for the
        real images with more than 2 context tokens, times
        ``image_loss_mask``.  ``generator`` draws the resamplers' dropout
        in training mode; it and ``draws`` (``vae_noise``, ``noise``,
        ``timesteps``, ``uncond_drop``) go to `ImageDecoder.forward`."""
        c = self.cfg
        if attention_mask is None:
            attention_mask = (text_ids != c.special.pad_token_id).int()
        prep = self.prepare_mm_embeds(text_ids, image_tensors,
                                      num_image_per_seq, generator)
        hidden, _, _ = self.mm_decoder(
            prep["mm_embeds"],
            attention_mask=attention_mask,
            vision_hidden_states=prep["mmfs_values"],
            cross_attention_mask=prep["cross_attention_mask"],
        )
        logits = self.text_decoder(hidden)
        if gt_text_ids is not None:
            labels = gt_text_ids[:, 1:]
        else:
            labels = so.prepare_gt_text_ids(
                text_ids, attention_mask, c.special,
                ignore_prompt_token_offset=ignore_prompt_token_offset,
                ignore_noimage_cond_loss=ignore_noimage_cond_loss,
            )
        loss_txt = so.cross_entropy_ignore(logits[:, :-1], labels)
        out = dict(loss_txt=loss_txt, loss=loss_txt * c.loss_txt_weight)
        if c.image_decoder is None:
            return out

        ctx, ctx_mask, mmfs_values, mmfs_mask = self._image_decoder_inputs(
            hidden, text_ids, prep["soi_pos"], prep["pyramid"],
            num_image_per_seq)
        targets = (image_tensors_dec if image_tensors_dec is not None
                   else image_tensors)
        max_img = image_tensors.shape[1]
        img_valid = (torch.arange(max_img, device=text_ids.device)[None, :]
                     < num_image_per_seq[:, None]).float().reshape(-1)
        img_valid = img_valid * (ctx_mask.sum(dim=-1) > 2).float()
        if image_loss_mask is not None:
            img_valid = img_valid * image_loss_mask.reshape(-1).float()
        loss_img = self.image_decoder(
            rearrange(targets, "b n h w c -> (b n) h w c"), ctx, ctx_mask,
            img_valid, mmfs_values, mmfs_mask, generator=generator, **draws)
        out["loss_img"] = loss_img
        out["loss"] = out["loss"] + loss_img * c.loss_img_weight
        return out

    @torch.no_grad()
    def generate_image_inputs(self, text_ids, image_tensors,
                              num_image_per_seq, attention_mask=None):
        """The cache-free prefix forward (causal, with the padding as
        segment ids), then `_image_decoder_inputs`: the inputs of
        `generation.diffusion.generate_images` for every image slot."""
        c = self.cfg
        if attention_mask is None:
            attention_mask = (text_ids != c.special.pad_token_id).int()
        prep = self.prepare_mm_embeds(text_ids, image_tensors,
                                      num_image_per_seq)
        hidden, _, _ = self.mm_decoder(
            prep["mm_embeds"],
            attention_mask=attention_mask,
            vision_hidden_states=prep["mmfs_values"],
            cross_attention_mask=prep["cross_attention_mask"],
        )
        return self._image_decoder_inputs(hidden, text_ids, prep["soi_pos"],
                                          prep["pyramid"], num_image_per_seq)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init in place, on the model's own device and dtype:
    fan-in-scaled normal Linear/Conv kernels, zero biases, unit norms, then
    each module's own `init_weights` (the JAX package's special inits,
    zero gates included), children before parents."""
    g = generator
    for m in reversed(list(model.modules())):
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight.data
            w.normal_(0.0, w[0].numel() ** -0.5, generator=g)
            if m.bias is not None:
                m.bias.data.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.data.normal_(0.0, 0.02, generator=g)
        if hasattr(m, "init_weights"):
            m.init_weights(g)


def allocate_model(cfg: MMInterleavedConfig, device,
                   dtype: Optional[torch.dtype] = None) -> MMInterleaved:
    """The model with uninitialised storage on ``device`` in ``dtype``
    (default: the LLM's compute dtype), for weights loaded in full."""
    with torch.device("meta"):
        model = MMInterleaved(cfg)
    model = model.to(dtype=dtype or cfg.llm.compute_dtype)
    return model.to_empty(device=device)


def build_model(cfg: MMInterleavedConfig, device, dtype: Optional[torch.dtype] = None,
                seed: int = 0, optim=None) -> MMInterleaved:
    """The model with seeded random weights, made directly on ``device`` in
    ``dtype`` (default: the LLM's compute dtype): no full-precision copy is
    ever made on the host.

    With ``optim`` (an `engine.optim.OptimConfig`), the training form: the
    leaves that ``optim`` freezes get ``requires_grad=False``, and the
    model is in train mode.  Every leaf stays in ``dtype``, the compute
    dtype; `engine.optim.AdamW` keeps the fp32 masters of the trainable
    ones."""
    model = allocate_model(cfg, device, dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    init_weights(model, g)
    if optim is None:
        return model.eval()
    from ..engine.optim import freeze

    freeze(model, optim)
    return model.train()
