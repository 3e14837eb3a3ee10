"""The CLIP towers of the t2i rerank (`models/clip_text.py`,
`utils/fid.CLIPViTFeatures(projected=True)`, `evaluate.clip_rerank_fn`).

* The text tower against HF `CLIPTextModelWithProjection` and the JAX
  `CLIPTextModel` on one tiny seeded checkpoint, within 1e-5, a row with no
  end-of-text token included (JAX pools its last position; HF has no
  counterpart there).
* The rerank of the evaluation entry over an HF CLIP directory on disk
  (its own tiny tokenizer files): the projected image features and the
  text features against HF `CLIPModel.get_image_features` /
  `get_text_features` within 1e-5, and the same picks.
* The JAX entry's pairing (`evaluate.py:387-393,415-421`): the ViT's
  unprojected cls feature against the text projection fails to broadcast in
  its `make_clip_rerank_fn` wherever the ViT's width is not the projection
  width (ViT-L/14: 1024 against 768).
"""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mm_interleaved_tpu.models import clip_text as jclip
from mm_interleaved_tpu.utils import fid as jfid
from mm_interleaved_tpu_torch import evaluate
from mm_interleaved_tpu_torch.models import clip_text
from mm_interleaved_tpu_torch.models.visual_tokenizer import CLIP_MEAN, CLIP_STD
from mm_interleaved_tpu_torch.utils import fid
from mm_interleaved_tpu_torch.utils.name_map import check_coverage
from mm_interleaved_tpu_torch.utils.state_dict_io import load_torch_state_dict

CHARS = "abcdefghijklmnopqrstuvwxyz"
VOCAB = len(CHARS) * 2 + 2
BOS, EOS = VOCAB - 2, VOCAB - 1
TEXT = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16)
VISION = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
              num_attention_heads=4, image_size=28, patch_size=14)
PROJ = 24


def hf_clip():
    from transformers import CLIPConfig, CLIPModel

    torch.manual_seed(0)
    cfg = CLIPConfig(
        text_config=dict(vocab_size=VOCAB, eos_token_id=EOS,
                         bos_token_id=BOS, **TEXT),
        vision_config=VISION, projection_dim=PROJ,
        attn_implementation="eager")
    model = CLIPModel(cfg).eval()
    with torch.no_grad():  # norms and biases off their init
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """An HF CLIP directory: the safetensors weights, config.json and the
    files of a character-level tokenizer."""
    d = tmp_path_factory.mktemp("clip")
    model = hf_clip()
    model.save_pretrained(d, safe_serialization=True)
    vocab = {c: i for i, c in enumerate(CHARS)}
    vocab.update({c + "</w>": len(CHARS) + i for i, c in enumerate(CHARS)})
    vocab.update({"<|startoftext|>": BOS, "<|endoftext|>": EOS})
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n")
    return str(d), model


def test_text_tower_matches_hf_and_jax(clip_dir):
    path, hf = clip_dir
    sd = load_torch_state_dict(path)
    text, _ = clip_text.load_clip(sd, "cpu", heads=(4, 4), eos_token_id=EOS)
    ids = np.array([[BOS, 5, 9, 23, EOS, EOS, EOS, EOS],
                    [BOS, 7, EOS, 3, 4, EOS, EOS, EOS],
                    [BOS, 1, 2, 3, 4, 5, 6, 7]], np.int64)  # no EOS
    with torch.no_grad():
        hidden, feats = text(torch.from_numpy(ids))
        out = hf.text_model(input_ids=torch.from_numpy(ids[:2]))
        want = hf.text_projection(out.pooler_output)
    np.testing.assert_allclose(hidden[:2].numpy(),
                               out.last_hidden_state.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(feats[:2].numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    jcfg = jclip.CLIPTextConfig(vocab_size=VOCAB, projection_dim=PROJ,
                                eos_token_id=EOS, **TEXT)
    np_sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    params = jclip.convert_clip_text(np_sd, num_layers=2)
    jh, jf = jclip.CLIPTextModel(jcfg).apply({"params": params},
                                             jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), atol=1e-5,
                               rtol=1e-5)


def test_clip_converters_are_strict(clip_dir):
    """Every key of the directory but ``logit_scale`` and the position ids
    is read; a stray key raises."""
    path, _ = clip_dir
    sd = load_torch_state_dict(path)
    text_cfg, vision_cfg, _ = clip_text.clip_configs(sd, (4, 4), EOS)
    with torch.device("meta"):
        text = clip_text.CLIPTextModel(text_cfg)
    nmap = clip_text.convert_clip_text(text_cfg.num_hidden_layers)
    keys = [k for k in sd if k.startswith("text_model.")
            and not k.endswith("position_ids")] + ["text_projection.weight"]
    check_coverage(nmap, keys, dict(text.named_parameters()))
    with pytest.raises(KeyError, match="no entry reads"):
        check_coverage(nmap, keys + ["text_model.extra.weight"],
                       dict(text.named_parameters()))


def test_projected_rerank_matches_hf(clip_dir):
    path, hf = clip_dir
    C, B = 3, 2
    images = np.random.RandomState(0).rand(C * B, 28, 28, 3).astype(np.float32)
    captions = ["a red dog", "two cats"]
    image_fn, text_fn = evaluate.clip_feature_fns(path, torch.device("cpu"))
    rerank = fid.make_clip_rerank_fn(image_fn, text_fn)
    from transformers import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(path)
    ids = tok(captions, padding="max_length", truncation=True, max_length=16,
              return_tensors="pt")["input_ids"]
    mean, std = torch.tensor(CLIP_MEAN), torch.tensor(CLIP_STD)
    pix = ((torch.from_numpy(images) - mean) / std).permute(0, 3, 1, 2)
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=pix).numpy()
        want_txt = hf.get_text_features(input_ids=ids).numpy()
    got_img, got_txt = image_fn(images), text_fn(captions)
    assert got_img.shape == (C * B, PROJ) and got_txt.shape == (B, PROJ)
    np.testing.assert_allclose(got_img, want_img, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_txt, want_txt, atol=1e-5, rtol=1e-5)
    img_n = want_img / np.linalg.norm(want_img, axis=-1, keepdims=True)
    txt_n = want_txt / np.linalg.norm(want_txt, axis=-1, keepdims=True)
    want_pick = (img_n.reshape(C, B, -1) * txt_n[None]).sum(-1).argmax(0)
    np.testing.assert_array_equal(rerank(images, captions), want_pick)


def test_jax_pairing_fails_where_widths_differ():
    """The JAX entry pairs the ViT's cls feature (ViT-L/14: 1024) with the
    CLIP text projection (768): its own rerank helper cannot broadcast
    them.  The port pairs projected features of one width."""
    rs = np.random.RandomState(0)
    C, B = 2, 2
    cls = lambda images: rs.randn(len(images), 1024)  # noqa: E731
    text = lambda captions: rs.randn(len(captions), 768)  # noqa: E731
    images = np.zeros((C * B, 4, 4, 3), np.float32)
    with pytest.raises(ValueError, match="broadcast"):
        jfid.make_clip_rerank_fn(cls, text)(images, ["a", "b"])
    projected = lambda images: rs.randn(len(images), 768)  # noqa: E731
    picks = fid.make_clip_rerank_fn(projected, text)(images, ["a", "b"])
    assert picks.shape == (B,) and set(picks) <= {0, 1}


def test_projected_features_need_the_projection():
    """`CLIPViTFeatures(projected=True)` over an encoder without
    ``post_layernorm`` / ``visual_projection`` raises."""
    from mm_interleaved_tpu_torch.models.vit import ViTConfig, ViTEmbeddings

    class Core(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embeddings = ViTEmbeddings(ViTConfig(hidden_size=8,
                                                      image_size=28))

    with pytest.raises(ValueError, match="CLIPVisionTower"):
        fid.CLIPViTFeatures(Core(), projected=True)
