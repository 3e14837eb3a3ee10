"""Beam search, the KV-cache tile and reorder, and `generate_scores` of the
PyTorch port against the JAX package's, on the tiny preset without image
decoder (``scan_layers=True``), every param leaf replaced by seeded noise,
set up as tests/test_torch_generation.py.

Beam tokens must be identical to JAX's `beam_search` for K in {1, 3, 5},
length penalties 0, 1 and 2 with and without the eos in the length, five
stop tokens (multi-eos early stop) and ``min_new_tokens``.  The cache tile
and reorder are bit-identical; `generate_scores` within atol 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.generation.beam import _tile_beams
from mm_interleaved_tpu.generation.beam import beam_search as j_beam_search
from mm_interleaved_tpu.generation.scores import (
    generate_scores as j_generate_scores,
)
from mm_interleaved_tpu.generation.text import TextGenerationConfig as JGenCfg
from mm_interleaved_tpu.models.llama import KVCache as JKVCache
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.generation.beam import beam_search, top_k
from mm_interleaved_tpu_torch.generation.scores import generate_scores
from mm_interleaved_tpu_torch.generation.text import (
    TextGenerationConfig,
    generate_texts,
    generate_tokens,
)
from mm_interleaved_tpu_torch.models.llama import KVCache
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.utils.from_flax import load_flax_params

from _torch_parity import close, init_tiny, t

NEW = 8


@pytest.fixture(scope="module")
def setup():
    cfg, jmodel, params, batch = init_tiny(scan_layers=True)
    model = build_model(tcfg.tiny_config(with_image_decoder=False),
                        "cpu", torch.float32)
    load_flax_params(model, params["params"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v).long() if v.dtype == np.int32 else t(v)
          for k, v in batch.items()}
    jprep = jmodel.apply(params, jb["text_ids"], jb["image_tensors"],
                         jb["num_image_per_seq"],
                         method=jmodel.prepare_mm_embeds)
    tprep = model.prepare_mm_embeds(tb["text_ids"], tb["image_tensors"],
                                    tb["num_image_per_seq"])
    return cfg, jmodel, params, model, jb, tb, jprep, tprep


def _cfgs(cfg, **kw):
    s = cfg.special
    kw = dict(max_new_tokens=NEW, pad_token_id=s.pad_token_id, **kw)
    return JGenCfg(**kw), TextGenerationConfig(**kw)


def _beams(setup, **kw):
    cfg, jmodel, params, model, jb, tb, jprep, tprep = setup
    jcfg, pcfg = _cfgs(cfg, **kw)
    want = np.asarray(j_beam_search(
        jmodel, params, jprep["mm_embeds"], jb["attention_mask"],
        jprep["mmfs_values"], jprep["cross_attention_mask"], jcfg))
    got = beam_search(model, tprep["mm_embeds"], tb["attention_mask"],
                      tprep["mmfs_values"], tprep["cross_attention_mask"],
                      pcfg).numpy()
    return want, got


@pytest.mark.parametrize("lp_includes_eos", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 1.0, 2.0])
@pytest.mark.parametrize("K", [1, 3, 5])
def test_beam_tokens_equal_jax(setup, K, alpha, lp_includes_eos):
    """Exact tokens.  Five stop ids (<eos>, <soi> and three frequent
    tokens of these weights) stop hypotheses early, ``min_new_tokens=2``
    masks them at the first two steps."""
    s = setup[0].special
    want, got = _beams(setup, num_beams=K, length_penalty=alpha,
                       lp_includes_eos=lp_includes_eos, min_new_tokens=2,
                       eos_token_ids=(s.eos_token_id, s.soi_token_id, 7, 9,
                                      11))
    np.testing.assert_array_equal(got, want)


def test_beam_stops_early_on_a_stop_token(setup):
    """The stop-token case above really stops: some row's best hypothesis
    ends before ``NEW`` tokens and is padded after its stop token."""
    s = setup[0].special
    stops = (s.eos_token_id, s.soi_token_id, 7, 9, 11)
    _, got = _beams(setup, num_beams=3, length_penalty=0.0,
                    min_new_tokens=2, eos_token_ids=stops)
    stopped = [row for row in got if row[-1] == s.pad_token_id]
    assert stopped and all(row[np.argmax(np.isin(row, stops))] in stops
                           for row in stopped)


def test_beam1_equals_greedy(setup):
    """K = 1 beam search gives the port's own greedy tokens."""
    cfg, _, _, model, _, tb, _, tprep = setup
    _, pcfg = _cfgs(cfg, eos_token_ids=(999,))
    greedy = generate_tokens(model, tprep["mm_embeds"], tb["attention_mask"],
                             tprep["mmfs_values"],
                             tprep["cross_attention_mask"], pcfg)
    beam = beam_search(model, tprep["mm_embeds"], tb["attention_mask"],
                       tprep["mmfs_values"], tprep["cross_attention_mask"],
                       dataclasses.replace(pcfg, num_beams=1))
    assert torch.equal(beam, greedy)


def test_generate_texts_routes_beams_to_beam_search(setup):
    """``num_beams > 1`` in `generate_texts` is the beam search."""
    cfg, _, _, model, _, tb, _, tprep = setup
    _, pcfg = _cfgs(cfg, num_beams=3)
    got = generate_texts(model, tb["text_ids"], tb["image_tensors"],
                         tb["num_image_per_seq"], tb["attention_mask"], pcfg)
    want = beam_search(model, tprep["mm_embeds"], tb["attention_mask"],
                       tprep["mmfs_values"], tprep["cross_attention_mask"],
                       pcfg)
    assert torch.equal(got, want)


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    """The selections are full of NEG_INF ties: the order is JAX's."""
    rs = np.random.RandomState(0)
    x = rs.randint(0, 3, (4, 40)).astype(np.float32)
    x[:, ::3] = -1.0e7
    wv, wi = jax.lax.top_k(jnp.asarray(x), 12)
    gv, gi = top_k(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _caches(cfg, B, seed=0):
    """The same random cache in both layouts (3 layers' worth of slots)."""
    rs = np.random.RandomState(seed)
    c = cfg.llm
    shape = (c.num_hidden_layers, B, 11, c.kv_heads, c.head_dim)
    k, v = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    valid = rs.rand(B, 11) > 0.3
    return (JKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
                     jnp.int32(7)),
            KVCache(t(k), t(v), t(valid), 7))


def test_kv_cache_tile_and_reorder_equal_jax(setup):
    """The beam tile (each row K times in place) and the reorder by beam
    index, bit for bit; the reorder into a second buffer writes that
    buffer."""
    cfg = setup[0]
    B, K = 2, 3
    jc, pc = _caches(cfg, B)
    jt = JKVCache(
        k=_tile_beams(jc.k.swapaxes(0, 1), K).swapaxes(0, 1),
        v=_tile_beams(jc.v.swapaxes(0, 1), K).swapaxes(0, 1),
        valid=_tile_beams(jc.valid, K), length=jc.length)
    pt = pc.tile(K)
    for a, b in ((pt.k, jt.k), (pt.v, jt.v), (pt.valid, jt.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = np.array([2, 2, 0, 4, 5, 3])
    jr = jt.reorder(jnp.asarray(idx))
    spare = KVCache(torch.empty_like(pt.k), torch.empty_like(pt.v),
                    torch.empty_like(pt.valid), 0)
    ptrs = (spare.k.data_ptr(), spare.v.data_ptr(), spare.valid.data_ptr())
    pr = pt.reorder(torch.from_numpy(idx), out=spare)
    assert pr is spare and pr.length == 7
    assert (pr.k.data_ptr(), pr.v.data_ptr(), pr.valid.data_ptr()) == ptrs
    for a, b in ((pr.k, jr.k), (pr.v, jr.v), (pr.valid, jr.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_generate_scores_match_jax(setup):
    """Option log-prob scores of 3 options a row, in chunks of 4 rows (the
    tail chunk of 2 unpadded), within atol 1e-4."""
    cfg, jmodel, params, model, jb, tb, _, _ = setup
    rs = np.random.RandomState(3)
    opts = rs.randint(3, 100, (2, 3, 5)).astype(np.int32)
    mask = (rs.rand(2, 3, 5) > 0.3).astype(np.int32)
    mask[:, :, 0] = 1
    want = j_generate_scores(
        jmodel, params, jb["text_ids"], jnp.asarray(opts), jnp.asarray(mask),
        jb["image_tensors"], jb["num_image_per_seq"], jb["attention_mask"])
    got = generate_scores(model, tb["text_ids"], t(opts).long(), t(mask),
                          tb["image_tensors"], tb["num_image_per_seq"],
                          tb["attention_mask"])
    assert got.shape == (2, 3)
    close(got, want, 0, 1e-4)
