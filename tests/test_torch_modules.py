"""PyTorch port vs JAX, module by module, on one shared tiny init
(``scan_layers=False``) whose every leaf is seeded noise.

Each test runs the JAX module on its params subtree and the port's module
on the same subtree carried over by `utils.from_flax`, fp32 on the CPU.
Tolerances are stated per test: rtol 1e-4 with an atol at 1e-5 of the
output scale for single layers, 1e-4 for the deep stacks (adapter,
tokenizer), where fp32 rounding compounds over ~20 layers.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.models import stream_ops as jso
from mm_interleaved_tpu.models.deform_attn import (
    MSDeformAttn as JMSDeformAttn, grid_reference_points,
)
from mm_interleaved_tpu.models.llama import (
    LlamaAttention as JAttention, LlamaConfig as JLlamaConfig,
    LlamaDecoderLayer as JLayer, stack_llama_layers,
)
from mm_interleaved_tpu.models.mmfs import MMFS as JMMFS
from mm_interleaved_tpu.models.perceiver import (
    PerceiverResampler as JPerceiver,
)
from mm_interleaved_tpu.models.visual_tokenizer import (
    VisualTokenizer as JVisualTokenizer,
)
from mm_interleaved_tpu.models.vit import (
    ViTEmbeddings as JViTEmbeddings, ViTLayer as JViTLayer,
)
from mm_interleaved_tpu.models.vit_adapter import (
    CLIPViTAdapter as JAdapter,
)
from mm_interleaved_tpu.ops.rotary import rotary_cos_sin as j_cos_sin
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.models import stream_ops as tso
from mm_interleaved_tpu_torch.models.deform_attn import MSDeformAttn
from mm_interleaved_tpu_torch.models.llama import (
    LlamaAttention, LlamaConfig, LlamaDecoderLayer,
)
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.models.mmfs import MMFS
from mm_interleaved_tpu_torch.models.perceiver import PerceiverResampler
from mm_interleaved_tpu_torch.models.visual_tokenizer import VisualTokenizer
from mm_interleaved_tpu_torch.models.vit import ViTEmbeddings, ViTLayer
from mm_interleaved_tpu_torch.models.vit_adapter import CLIPViTAdapter
from mm_interleaved_tpu_torch.ops.rotary import rotary_cos_sin
from mm_interleaved_tpu_torch.utils.from_flax import (
    convert_params, load_flax_params,
)

from _torch_parity import close, init_tiny, t


@pytest.fixture(scope="module")
def tiny():
    cfg, model, params, batch = init_tiny(scan_layers=False)
    return cfg, params["params"], batch


def _port(module, params):
    load_flax_params(module, params)
    return module.eval()


def _pixels(cfg, n=2, seed=0):
    size = cfg.visual.encoder.vit.image_size
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(
        np.float32)


def test_bridge_loads_whole_model_strict_in_both_layouts(tiny):
    """The unrolled tree loads with strict=True; the scan_layers layout of
    the same weights converts to the identical state dict."""
    cfg, p, _ = tiny
    model = build_model(tcfg.tiny_config(with_image_decoder=False,
                                         scan_layers=False),
                        "cpu", torch.float32)
    load_flax_params(model, p)
    flat = convert_params(p)
    stacked = dict(p)
    stacked["mm_decoder"] = stack_llama_layers(
        p["mm_decoder"], cfg.llm.num_hidden_layers,
        cfg.llm.cross_attention_frequency,
    )
    flat_s = convert_params(stacked)
    assert flat.keys() == flat_s.keys()
    for k in flat:
        assert torch.equal(flat[k], flat_s[k]), k
    w = p["visual_tokenizer"]["encoder"]["adapter_up"]["kernel"]
    assert torch.equal(flat["visual_tokenizer.encoder.adapter_up.weight"],
                       t(np.transpose(w[::-1, ::-1], (2, 3, 0, 1))))


def test_vit_embeddings_and_layer(tiny):
    cfg, p, _ = tiny
    vit = cfg.visual.encoder.vit
    enc = p["visual_tokenizer"]["encoder"]
    x = _pixels(cfg)
    want = JViTEmbeddings(vit).apply({"params": enc["embeddings"]},
                                     jnp.asarray(x))
    tvit = tcfg.tiny_config().visual.encoder.vit
    got = _port(ViTEmbeddings(tvit), enc["embeddings"])(t(x))
    close(got, want, 1e-4, 1e-5)
    h = np.asarray(want)
    want = JViTLayer(vit).apply({"params": enc["layers_0"]}, jnp.asarray(h))
    got = _port(ViTLayer(tvit), enc["layers_0"])(t(h))
    close(got, want, 1e-4, 1e-5)


@pytest.mark.parametrize("role", ["injector", "extractor"])
def test_ms_deform_attn_module(tiny, role):
    cfg, p, _ = tiny
    c = cfg.visual.encoder
    levels = c.injector_levels if role == "injector" else c.extractor_levels
    q_levels = ((c.grid, c.grid),) if role == "injector" else \
        c.injector_levels
    sub = p["visual_tokenizer"]["encoder"][f"interactions_0_{role}"]["attn"]
    rs = np.random.RandomState(2)
    Lq = sum(h * w for h, w in q_levels)
    S = sum(h * w for h, w in levels)
    query = rs.randn(2, Lq, c.dim).astype(np.float32)
    feat = rs.randn(2, S, c.dim).astype(np.float32)
    ref = grid_reference_points(q_levels)[None]
    kw = dict(d_model=c.dim, n_heads=c.vit.num_attention_heads,
              n_points=c.n_points, ratio=c.deform_ratio, level_shapes=levels)
    want = JMSDeformAttn(**kw).apply({"params": sub}, jnp.asarray(query),
                                     jnp.asarray(ref), jnp.asarray(feat))
    got = _port(MSDeformAttn(**kw), sub)(t(query), t(ref), t(feat))
    close(got, want, 1e-4, 1e-5)


def test_adapter_pyramid(tiny):
    cfg, p, _ = tiny
    enc = p["visual_tokenizer"]["encoder"]
    x = _pixels(cfg)
    last, pyr = JAdapter(cfg.visual.encoder).apply({"params": enc},
                                                   jnp.asarray(x))
    tlast, tpyr = _port(CLIPViTAdapter(tcfg.tiny_config().visual.encoder),
                        enc)(t(x))
    close(tlast, last, 1e-4, 1e-4)
    assert [tuple(f.shape) for f in tpyr] == [f.shape for f in pyr]
    for a, b in zip(tpyr, pyr):
        close(a, b, 1e-4, 1e-4)


def test_perceiver(tiny):
    cfg, p, _ = tiny
    sub = p["visual_tokenizer"]["perceiver_resampler"]
    enc = np.random.RandomState(3).randn(2, 17, 32).astype(np.float32)
    want = JPerceiver(cfg.visual.perceiver).apply({"params": sub},
                                                  jnp.asarray(enc))
    got = _port(PerceiverResampler(tcfg.tiny_config().visual.perceiver),
                sub)(t(enc))
    close(got, want, 1e-4, 1e-5)


def test_visual_tokenizer(tiny):
    cfg, p, _ = tiny
    sub = p["visual_tokenizer"]
    x = _pixels(cfg)
    want = JVisualTokenizer(cfg.visual).apply({"params": sub}, jnp.asarray(x))
    got = _port(VisualTokenizer(tcfg.tiny_config().visual), sub)(t(x))
    close(got["vis_embed"], want["vis_embed"], 1e-4, 1e-4)
    close(got["image_embeds"], want["image_embeds"], 1e-4, 1e-4)
    for a, b in zip(got["multiscale_features"], want["multiscale_features"]):
        close(a, b, 1e-4, 1e-4)


def test_stream_ops_match_jax():
    """Exact (integer) ops, and the embedding scatter bit for bit."""
    rs = np.random.RandomState(4)
    B, L, max_img, n_tok, C = 3, 40, 3, 4, 8
    bos, soi, img = 1, 121, 122
    ids = rs.randint(3, 100, (B, L)).astype(np.int32)
    for b, starts in enumerate([(2, 20), (5,), (1, 12, 25, 33)]):
        ids[b, 0] = bos
        for s_ in starts:
            ids[b, s_] = soi
            ids[b, s_ + 1:s_ + 1 + n_tok] = img
        ids[b, 15] = bos
    n_img = np.array([2, 1, 3], np.int32)
    ti = t(ids).long()
    close(tso.token_positions(ti, soi, max_img),
          jso.token_positions(jnp.asarray(ids), soi, max_img), 0, 0)
    close(tso.nearest_bos_positions(ti, bos),
          jso.nearest_bos_positions(jnp.asarray(ids), bos), 0, 0)
    m_t, s_t = tso.mm_cross_attention_mask(ti, t(n_img), soi, bos, max_img)
    m_j, s_j = jso.mm_cross_attention_mask(jnp.asarray(ids),
                                           jnp.asarray(n_img), soi, bos,
                                           max_img)
    close(m_t, m_j, 0, 0)
    close(s_t, s_j, 0, 0)
    emb = rs.randn(B, L, C).astype(np.float32)
    vis = rs.randn(B, max_img, n_tok, C).astype(np.float32)
    soi_e = rs.randn(C).astype(np.float32)
    close(tso.scatter_image_embeds(t(emb), ti, t(vis), img),
          jso.scatter_image_embeds(jnp.asarray(emb), jnp.asarray(ids),
                                   jnp.asarray(vis), img), 0, 0)
    close(tso.add_soi_embeds(t(emb), ti, t(soi_e), soi),
          jso.add_soi_embeds(jnp.asarray(emb), jnp.asarray(ids),
                             jnp.asarray(soi_e), soi), 0, 0)


def _mmfs_kwargs(llm):
    return dict(
        d_model=llm.hidden_size, d_query=llm.hidden_size,
        d_value=llm.image_embed_dim, d_out=llm.hidden_size,
        n_heads=llm.mmfs_heads, n_points=llm.mmfs_points,
        ratio=llm.image_embed_dim / llm.hidden_size,
        level_shapes=llm.level_shapes, base_spatial_shape=16,
        max_num_image_per_seq=llm.max_num_image_per_seq,
    )


@pytest.mark.parametrize("Lq", [1, 24])
def test_mmfs_llm_branch(tiny, Lq):
    """Per-query masks with an all-masked row and the folded ignore token;
    the returned value projection matches the one JAX sows, and feeding it
    back (the decode path) gives the same output (rtol 1e-4)."""
    cfg, p, _ = tiny
    llm = cfg.llm
    sub = p["mm_decoder"]["layers_0"]["llama_cross_attn"]["attn"]
    rs = np.random.RandomState(5)
    B, n_img = 2, 3
    hw = sum(h * w for h, w in llm.level_shapes)
    query = rs.randn(B, Lq, llm.hidden_size).astype(np.float32)
    vis = rs.randn(B, n_img, hw, llm.image_embed_dim).astype(np.float32)
    mask = (rs.rand(B, Lq, n_img) > 0.4).astype(np.int32)
    mask[0, 0] = 0
    want, inters = JMMFS(**_mmfs_kwargs(llm)).apply(
        {"params": sub}, jnp.asarray(query), jnp.asarray(vis),
        jnp.asarray(mask), mutable=["intermediates"],
    )
    mod = _port(MMFS(**_mmfs_kwargs(llm)), sub)
    got, value = mod(t(query), t(vis), t(mask))
    close(got, want, 1e-4, 1e-5)
    close(value, inters["intermediates"]["projected_value"][0], 1e-5, 1e-6)
    again, _ = mod(t(query), None, t(mask), projected_value=value)
    close(again, got, 0, 0)


def test_llama_layer_with_cache(tiny):
    """The MMFS-gated layer 0: a 6-token prefill into an empty cache, then
    one decode token; outputs and cache contents match (rtol 1e-4)."""
    cfg, p, _ = tiny
    llm = cfg.llm
    sub = p["mm_decoder"]["layers_0"]
    rs = np.random.RandomState(6)
    B, T, max_len, n_img = 2, 6, 9, 2
    hw = sum(h * w for h, w in llm.level_shapes)
    vis = rs.randn(B, n_img, hw, llm.image_embed_dim).astype(np.float32)
    layer = _port(LlamaDecoderLayer(tcfg.tiny_config().llm, 0), sub)
    jlayer = JLayer(llm, 0)
    shape = (B, max_len, llm.kv_heads, llm.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    valid = np.zeros((B, max_len), bool)
    rope = rotary_cos_sin(llm.head_dim, llm.max_position_embeddings)
    length = 0
    for steps in (T, 1):
        x = rs.randn(B, steps, llm.hidden_size).astype(np.float32)
        att = np.ones((B, steps), bool)
        if length == 0:
            att[1, :2] = False  # left padding
        valid[:, length:length + steps] = att
        pos = np.maximum(np.cumsum(valid, 1) - valid, 0)[:, length:length + steps]
        slot = np.arange(max_len)[None, None]
        qi = length + np.arange(steps)[None, :, None]
        amask = ((slot <= qi)[:, None] & valid[:, None, None]).astype(bool)
        cross = (rs.rand(B, steps, n_img) > 0.3).astype(np.int32)
        want, (jk, jv) = jlayer.apply(
            {"params": sub}, jnp.asarray(x), jnp.asarray(pos),
            jnp.asarray(amask), jnp.asarray(vis), jnp.asarray(cross),
            (jk, jv), length,
        )
        got, _ = layer(t(x), t(pos).long(), rope, t(amask), t(vis), t(cross),
                       (tk, tv), length)
        close(got, want, 1e-4, 1e-5)
        close(tk, jk, 1e-5, 1e-6)
        close(tv, jv, 1e-5, 1e-6)
        length += steps
    jc, _ = j_cos_sin(llm.head_dim, llm.max_position_embeddings)
    close(rope[0], jc, 1e-5, 1e-6)


def test_llama_attention_gqa_with_cache():
    """Grouped-query attention (4 query heads over 2 kv heads) on its own
    init: prefill 5 tokens into the cache, then attend from 1 (rtol 1e-4)."""
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=1, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=32)
    jcfg_, tcfg_ = JLlamaConfig(**kw), LlamaConfig(**kw)
    rs = np.random.RandomState(7)
    B, T, max_len = 2, 5, 8
    shape = (B, max_len, 2, 8)
    x = rs.randn(B, T, 32).astype(np.float32)
    pos = np.tile(np.arange(T), (B, 1))
    amask = (np.arange(max_len)[None, None, None]
             <= np.arange(T)[None, None, :, None])
    amask = np.broadcast_to(amask, (B, 1, T, max_len))
    jatt = JAttention(jcfg_, 0)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(amask),
            (jnp.zeros(shape), jnp.zeros(shape)), 0)
    params = jax.tree.map(np.asarray, jatt.init(jax.random.PRNGKey(1), *args))
    want, (jk, _) = jatt.apply(params, *args)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    rope = rotary_cos_sin(8, 32)
    att = _port(LlamaAttention(tcfg_), params["params"])
    got = att(t(x), t(pos).long(), rope, t(amask), (tk, tv), 0)
    close(got, want, 1e-4, 1e-5)
    close(tk, jk, 1e-5, 1e-6)


def test_seeded_init_writes_every_parameter():
    """`build_model` makes the weights on the target device from a seed:
    every parameter is written (none keeps the uninitialised memory of
    `to_empty`), the JAX package's zero inits hold, and the seed decides."""
    from mm_interleaved_tpu_torch.models.mm_interleaved import init_weights

    cfg = tcfg.tiny_config(with_image_decoder=False)
    model = build_model(cfg, "cpu", torch.float32, seed=3)
    for p in model.parameters():
        p.data.fill_(float("nan"))
    init_weights(model, torch.Generator().manual_seed(3))
    again = build_model(cfg, "cpu", torch.float32, seed=3)
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.isfinite(p).all(), name
        assert torch.equal(p, q), name
    for name, p in model.named_parameters():
        if name.endswith(("gate", "gamma", "ignore_token", "soi_token",
                          "adapter_level_embed", "head_new.weight")):
            assert not p.any(), name
    assert (model.text_decoder.head.bias[cfg.orig_vocab_size:] == -100).all()


def test_llama_model_without_cache_matches_jax(tiny):
    """The cache-free forward (causal + segment ids over left padding) of
    the whole decoder stack, MMFS layers included (rtol 1e-4)."""
    from mm_interleaved_tpu.models.llama import LlamaModel as JLlamaModel
    from mm_interleaved_tpu_torch.models.llama import LlamaModel

    cfg, p, batch = tiny
    llm = cfg.llm
    rs = np.random.RandomState(8)
    B, T, n_img = 2, 7, 2
    hw = sum(h * w for h, w in llm.level_shapes)
    x = rs.randn(B, T, llm.hidden_size).astype(np.float32)
    att = np.ones((B, T), np.int32)
    att[1, :3] = 0
    vis = rs.randn(B, n_img, hw, llm.image_embed_dim).astype(np.float32)
    cross = (rs.rand(B, T, n_img) > 0.3).astype(np.int32)
    want, _ = JLlamaModel(llm).apply(
        {"params": p["mm_decoder"]}, jnp.asarray(x), jnp.asarray(att),
        jnp.asarray(vis), jnp.asarray(cross),
    )
    model = _port(LlamaModel(tcfg.tiny_config(scan_layers=False).llm),
                  p["mm_decoder"])
    got, cache, values = model(t(x), t(att), t(vis), t(cross))
    assert cache is None and len(values) == 2
    valid = att.astype(bool)  # padded rows attend nothing real: skip them
    close(got.detach().numpy()[valid], np.asarray(want)[valid], 1e-4, 1e-5)
