"""The port's converters (`utils/convert_hf.py`, `convert_sd.py`,
`convert_ref.py`, the tower and released-model modes of
`convert_checkpoint.py`) against the JAX converters carried over by
`utils.from_flax`: on the same numpy state dicts every converted tensor is
equal bit for bit, but the mean-padded embedding rows (within 1e-6
relative: numpy and torch sum in different orders).  Then the numbers: the
port's LLaMA on converted HF weights against HF's logits; and the
coverage, strict at the tiny preset and complete at the flagship's full
depth on the meta device (every parameter filled, every source key read or
skipped by name)."""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.utils import convert_ref as j_ref
from mm_interleaved_tpu_torch import convert_checkpoint
from mm_interleaved_tpu_torch.configs import flagship_config, tiny_config
from mm_interleaved_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                                   TextDecoder)
from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu_torch.utils import convert_hf, convert_ref, convert_sd
from mm_interleaved_tpu_torch.utils.from_flax import convert_params
from mm_interleaved_tpu_torch.utils.name_map import (check_coverage,
                                                     convert_entry,
                                                     stream_into)
from mm_interleaved_tpu_torch.utils.state_dict_io import load_torch_state_dict

from _torch_convert_assets import (REF_BUFFERS, ref_source, write_hf_towers)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def meta_shapes(cfg):
    with torch.device("meta"):
        model = MMInterleaved(cfg)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def converted(parts):
    """``{port name: tensor}`` of the parts' maps, each part's coverage
    checked first."""
    out = {}
    for sd, nmap, skips in parts:
        check_coverage(nmap, sd.keys(), SHAPES, skips, full=False)
        out.update((n, convert_entry(e, sd)) for n, e in nmap.items())
    return out


SHAPES = meta_shapes(tiny_config(with_image_decoder=True))


def test_ref_converter_equals_jax():
    cfg = tiny_config(with_image_decoder=True)
    sd = ref_source(cfg)
    nmap = convert_ref.convert_mm_interleaved(cfg, SHAPES.__contains__)
    check_coverage(nmap, sd, SHAPES, convert_ref.REF_SKIPS)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = {n: convert_entry(e, tsd) for n, e in nmap.items()}
    want = convert_params(j_ref.convert_mm_interleaved(
        sd, j_tiny(with_image_decoder=True)))
    assert set(got) == set(want) == set(SHAPES)
    for n, w in want.items():
        assert torch.equal(got[n], w), n


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    return write_hf_towers(str(tmp_path_factory.mktemp("towers")))


def test_tower_converters_equal_jax(towers):
    """`convert_checkpoint.tower_parts` against the JAX script's
    `build_updates` (which reads the same files through the `safetensors`
    package), every converted tensor of the three towers."""
    llm_dir, clip_dir, sd_dir, _ = towers
    args = argparse.Namespace(ref_checkpoint=None, llm=llm_dir,
                              clip=clip_dir, sd=sd_dir)
    cfg = tiny_config(with_image_decoder=True)
    got = converted(convert_checkpoint.tower_parts(args, cfg, SHAPES))
    sys.path.insert(0, SCRIPTS)
    try:
        import convert_checkpoint as j_script
    finally:
        sys.path.remove(SCRIPTS)
    want = convert_params(j_script.build_updates(
        args, j_tiny(with_image_decoder=True)))
    assert set(got) == set(want)
    assert any(n.startswith("image_decoder.vae.") for n in got)
    emb = "mm_decoder.embed_tokens.weight"
    for n, w in want.items():
        if n == emb:
            continue
        assert torch.equal(got[n].float(), w), n
    assert torch.equal(got[emb][:120], want[emb][:120])
    # the padded rows: within 1e-6 of their scale (an element near zero
    # has no relative precision to hold), against JAX's and the fp64 mean
    pad = want[emb][120:].numpy()
    tol = 1e-6 * np.abs(pad).max()
    np.testing.assert_allclose(got[emb][120:].numpy(), pad, rtol=0, atol=tol)
    hf = load_torch_state_dict(llm_dir)["model.embed_tokens.weight"]
    mean = hf.double().mean(0).expand(8, -1).numpy()
    np.testing.assert_allclose(got[emb][120:].double().numpy(), mean, rtol=0,
                               atol=tol)
    # the new heads as built from lm_head
    assert (got["text_decoder.head.bias"][120:] == -100).all()
    assert (got["text_decoder.head_new.bias"] == 95).all()
    assert not got["text_decoder.head_new.weight"].any()


def test_llama_logits_match_hf(towers):
    """The port's LlamaModel and TextDecoder on the converted HF LLaMA give
    HF's hidden states and logits within 1e-5 (fp32)."""
    llm_dir, _, _, hf = towers
    sd = load_torch_state_dict(llm_dir)
    cfg = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=4, num_attention_heads=4,
                      max_position_embeddings=64, cross_attention_frequency=100)
    llm, head = LlamaModel(cfg), TextDecoder(cfg, orig_vocab_size=120)
    # layer 0 carries an MMFS block (0 % 100 == 0) that a text-only
    # forward does not run and HF has no weights for
    params = {f"llm.{n}": p for n, p in llm.named_parameters()
              if "llama_cross_attn" not in n}
    params.update((f"head.{n}", p) for n, p in head.named_parameters())
    lmap = convert_hf.convert_llama(4)
    lmap["embed_tokens.weight"] = convert_hf.padded_embedding(
        "model.embed_tokens.weight", 128, 120)
    nmap = {f"llm.{n}": e for n, e in lmap.items()}
    nmap.update((f"head.{n}", e) for n, e in
                convert_hf.convert_text_decoder(128, 120, 32).items())
    check_coverage(nmap, sd.keys(), params, convert_hf.LLAMA_SKIPS)
    stream_into(params, nmap, sd)
    ids = torch.tensor([[1, 5, 9, 23, 41, 2, 77, 119]])
    with torch.no_grad():
        hidden, _, _ = llm(llm.embed(ids))
        logits = head(hidden)
        out = hf(input_ids=ids, output_hidden_states=True)
    np.testing.assert_allclose(hidden.numpy(), out.hidden_states[-1].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits[..., :120].numpy(), out.logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert logits[..., 120:].max() < -4.0  # -100 + 95 at init


def test_coverage_is_strict_at_tiny():
    """A missing key, a stray key and an unfilled parameter each raise;
    the fixed buffers are skipped by name."""
    cfg = tiny_config(with_image_decoder=True)
    sd = ref_source(cfg)
    nmap = convert_ref.convert_mm_interleaved(cfg, SHAPES.__contains__)
    assert set(REF_BUFFERS) <= set(sd)
    check_coverage(nmap, sd, SHAPES, convert_ref.REF_SKIPS)
    key = "mm_decoder.model.layers.0.llama_cross_attn.attn.ignore_token"
    with pytest.raises(KeyError, match="source keys missing"):
        check_coverage(nmap, set(sd) - {key}, SHAPES, convert_ref.REF_SKIPS)
    with pytest.raises(KeyError, match="no entry reads"):
        check_coverage(nmap, list(sd) + ["mm_decoder.lm_head.weight"],
                       SHAPES, convert_ref.REF_SKIPS)
    with pytest.raises(KeyError, match="no entry reads"):
        check_coverage(nmap, sd, SHAPES, ())
    partial = dict(nmap)
    del partial["soi_token"]
    with pytest.raises(KeyError, match="no source key fills"):
        check_coverage(partial, sd, SHAPES, convert_ref.REF_SKIPS)
    with pytest.raises(KeyError, match="the model lacks"):
        check_coverage(dict(nmap, extra=nmap["soi_token"]), sd, SHAPES,
                       convert_ref.REF_SKIPS)


def test_coverage_at_flagship_full_depth():
    """On the meta device at `flagship_config`: the released-model map
    fills every parameter; the tower maps read every key of the released
    towers' own key sets (HF Vicuna-13B, CLIP ViT-L/14 as a full
    CLIPModel, the SD-2.1 UNet and VAE), but for the skips they name."""
    from transformers import (CLIPConfig, CLIPModel, LlamaConfig as HFLlama,
                              LlamaForCausalLM)

    from _reference_sd import TorchMiniUNet, TorchMiniVAE

    cfg = flagship_config()
    shapes = meta_shapes(cfg)
    nmap = convert_ref.convert_mm_interleaved(cfg, shapes.__contains__)
    keys = {k for e in nmap.values() for k in e.keys}
    check_coverage(nmap, list(keys) + list(REF_BUFFERS), shapes,
                   convert_ref.REF_SKIPS)
    assert set(nmap) == set(shapes)
    with torch.device("meta"):
        hf_llm = LlamaForCausalLM(HFLlama(
            vocab_size=32000, hidden_size=5120, intermediate_size=13824,
            num_hidden_layers=40, num_attention_heads=40))
        clip = CLIPModel(CLIPConfig(
            text_config=dict(hidden_size=768, intermediate_size=3072,
                             num_attention_heads=12, num_hidden_layers=12),
            vision_config=dict(hidden_size=1024, intermediate_size=4096,
                               num_attention_heads=16, num_hidden_layers=24,
                               patch_size=14, image_size=224),
            projection_dim=768))
        unet = TorchMiniUNet(block_out=(320, 640, 1280, 1280),
                             layers_per_block=2, ctx_dim=1024, head_dim=64,
                             groups=32)
        vae = TorchMiniVAE(block_out=(128, 256, 512, 512), layers_per_block=2,
                           groups=32)
    keys = list(hf_llm.state_dict()) + ["model.layers.0.self_attn.rotary_emb.inv_freq"]
    llm = convert_hf.convert_llama(40)
    llm["embed_tokens.weight"] = convert_hf.padded_embedding(
        "model.embed_tokens.weight", 32002, 32000)
    lmap = {f"mm_decoder.{n}": e for n, e in llm.items()}
    lmap.update((f"text_decoder.{n}", e) for n, e in
                convert_hf.convert_text_decoder(32002, 32000, 5120).items())
    check_coverage(lmap, keys, shapes, convert_hf.LLAMA_SKIPS, full=False)
    vit = {f"visual_tokenizer.encoder.{n}": e
           for n, e in convert_hf.convert_clip_vit(24).items()}
    check_coverage(vit, clip.state_dict().keys(), shapes,
                   convert_hf.CLIP_VISION_SKIPS, full=False)
    for sub, model, fn in (("unet", unet, convert_sd.convert_sd_unet),
                           ("vae", vae, convert_sd.convert_sd_vae)):
        root = f"image_decoder.{sub}."
        c = getattr(cfg.image_decoder, sub)
        smap = fn(len(c.block_out_channels), c.layers_per_block,
                  lambda n: (root + n) in shapes)
        check_coverage({root + n: e for n, e in smap.items()},
                       model.state_dict().keys(), shapes, full=False)
