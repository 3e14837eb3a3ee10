"""The slice end to end: `generate_texts` of the PyTorch port against the JAX
package's, on the tiny preset without image decoder (``scan_layers=True``,
the preset's default, so the bridge unstacks the scanned layers), set up
as in tests/test_generation.py, every param leaf replaced by seeded noise.

Greedy tokens must be identical.  The logits of the prefill and of every
decode step, teacher-forced along the JAX tokens, agree to atol 1e-4; the
test asserts each step's top-2 margin is well above that, so a near-tie
fails loudly instead of flaking.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.generation.text import (
    TextGenerationConfig as JGenCfg,
    _apply_repetition_penalty,
    extract_vision_values,
    generate_texts as j_generate_texts,
)
from mm_interleaved_tpu.models.llama import KVCache as JKVCache
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.generation.text import (
    TextGenerationConfig,
    apply_repetition_penalty,
    generate_texts,
    mask_eos_before_min,
    sample_token,
)
from mm_interleaved_tpu_torch.models.llama import KVCache
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.utils.from_flax import load_flax_params

from _torch_parity import close, init_tiny, t

NEW = 6
ATOL = 1e-4


@pytest.fixture(scope="module")
def slice_setup():
    cfg, jmodel, params, batch = init_tiny(scan_layers=True)
    assert "block" in params["params"]["mm_decoder"]
    model = build_model(tcfg.tiny_config(with_image_decoder=False),
                        "cpu", torch.float32)
    load_flax_params(model, params["params"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: t(v).long() if v.dtype == np.int32 else t(v)
          for k, v in batch.items()}
    setup = (cfg, jmodel, params, model, jb, tb)
    free = _jax_generate(setup, eos_token_ids=(999,))  # never stops
    return setup + (free,)


def _gen_cfgs(cfg, **kw):
    s = cfg.special
    kw = dict(max_new_tokens=NEW, pad_token_id=s.pad_token_id, **kw)
    return JGenCfg(**kw), TextGenerationConfig(**kw)


def _jax_generate(setup, **kw):
    cfg, jmodel, params, model, jb, tb = setup[:6]
    return np.asarray(j_generate_texts(
        jmodel, params, jb["text_ids"], jb["image_tensors"],
        jb["num_image_per_seq"], jb["attention_mask"], _gen_cfgs(cfg, **kw)[0],
    ))


def _port_generate(setup, **kw):
    cfg, jmodel, params, model, jb, tb = setup[:6]
    return generate_texts(
        model, tb["text_ids"], tb["image_tensors"], tb["num_image_per_seq"],
        tb["attention_mask"], _gen_cfgs(cfg, **kw)[1],
    ).numpy()


def test_greedy_tokens_match_jax(slice_setup):
    got = _port_generate(slice_setup, eos_token_ids=(999,))
    assert got.shape == (2, NEW)
    np.testing.assert_array_equal(got, slice_setup[-1])


def test_stop_tokens_and_min_length_match_jax(slice_setup):
    """Pad after the first stop token, and no stop before min_new_tokens,
    as JAX does (the stop token is one the free run emits at step 1)."""
    stop = int(slice_setup[-1][0, 1])
    for min_new in (0, 3):
        kw = dict(eos_token_ids=(stop,), min_new_tokens=min_new,
                  repetition_penalty=1.3)
        np.testing.assert_array_equal(_port_generate(slice_setup, **kw),
                                      _jax_generate(slice_setup, **kw))


def test_logits_match_along_jax_tokens(slice_setup):
    cfg, jmodel, params, model, jb, tb, tokens = slice_setup
    B, L = batch_shape = jb["text_ids"].shape
    att = jb["attention_mask"]

    # JAX: prefill, then steps fed the JAX tokens
    prep = jmodel.apply(params, jb["text_ids"], jb["image_tensors"],
                        jb["num_image_per_seq"],
                        method=jmodel.prepare_mm_embeds)
    cache = JKVCache.create(cfg.llm, B, L + NEW)
    (logits, _, cache), inters = jmodel.apply(
        params, prep["mm_embeds"], att, prep["mmfs_values"],
        prep["cross_attention_mask"], cache, method=jmodel.lm_prefill,
        mutable=["intermediates"],
    )
    vv = extract_vision_values(jmodel, inters)
    cross = prep["cross_attention_mask"][:, -1:]
    want = [np.asarray(logits[:, -1])]
    for i in range(NEW - 1):
        step, cache = jmodel.apply(
            params, jnp.asarray(tokens[:, i:i + 1]), jnp.ones((B, 1), jnp.int32),
            None, cross, cache, vv, method=jmodel.lm_decode_step,
        )
        want.append(np.asarray(step[:, 0]))
    want = np.stack(want, 1)

    # the port, the same way
    with torch.inference_mode():
        tprep = model.prepare_mm_embeds(tb["text_ids"], tb["image_tensors"],
                                        tb["num_image_per_seq"])
        tcache = KVCache.create(model.cfg.llm, B, L + NEW)
        tlogits, _, tcache, values = model.lm_prefill(
            tprep["mm_embeds"], tb["attention_mask"], tprep["mmfs_values"],
            tprep["cross_attention_mask"], tcache,
        )
        assert len(values) == cfg.llm.num_hidden_layers // \
            cfg.llm.cross_attention_frequency
        tcross = tprep["cross_attention_mask"][:, -1:]
        got = [tlogits[:, -1]]
        for i in range(NEW - 1):
            step, tcache = model.lm_decode_step(
                t(tokens[:, i:i + 1]).long(), torch.ones((B, 1)), None,
                tcross, tcache, values,
            )
            got.append(step[:, 0])
        got = torch.stack(got, 1).numpy()

    close(got, want, 0, ATOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min()
    assert margin > 10 * ATOL, f"near-tie in the reference logits: {margin}"
    np.testing.assert_array_equal(want.argmax(-1), tokens)
    assert batch_shape == tuple(tb["text_ids"].shape)


def test_sampling_helpers_match_jax():
    logits = np.array([[2.0, 1.0, 0.5, -1.0, -3.0]], np.float32)
    # probabilities .607, .223, .135, ...: top_p=0.8 keeps the top two
    cfg = TextGenerationConfig(do_sample=True, top_p=0.8, temperature=1.0)
    g = torch.Generator().manual_seed(0)
    seen = {int(sample_token(t(logits), cfg, g)[0]) for _ in range(50)}
    assert seen == {0, 1}
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    wide = dataclasses.replace(cfg, top_p=1.0)
    a = [int(sample_token(t(logits), wide, g1)[0]) for _ in range(20)]
    b = [int(sample_token(t(logits), wide, g2)[0]) for _ in range(20)]
    assert a == b  # the generator alone decides the draw
    pres = np.array([[True, True, False, True, False]])
    close(apply_repetition_penalty(t(logits), t(pres), 2.0),
          _apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(pres),
                                    2.0), 0, 0)
    masked = mask_eos_before_min(
        t(logits), 0, TextGenerationConfig(min_new_tokens=2,
                                           eos_token_ids=(0, 3)))
    assert masked[0, 0] == masked[0, 3] == torch.finfo(torch.float32).min
    assert masked[0, 1] == 1.0
