"""Int8 weight-only decode of the PyTorch port (`ops/quant.py`) against the
JAX package's (`mm_interleaved_tpu/ops/quant.py`), on seeded inputs and the
tiny preset without image decoder (``scan_layers=True``, every param leaf
noised):

  * `quantize_int8`'s codes and scales bit-identical to JAX's in fp32 (the
    port's ``[out, in]`` against JAX's ``[in, out]``), a scanned stack per
    block, a zero row at the 1e-8 floor;
  * `QLinear`'s plain path within 1e-6 of `QDense`, with and without bias;
  * the quantized layers exactly JAX's quantized leaves, mapped by
    `from_flax`, and a JAX-quantized tree carried across equal to the
    port's own quantization, tensor for tensor;
  * greedy tokens of the quantized tiny model equal to JAX's
    `LocalGenerator(quantize="int8")`, through `build_generation_runtime`;
  * the prefill's and a decode step's hidden states within JAX's own 0.05
    of the unquantized model (tests/test_quant.py:130-156);
  * the kernel's Python half: the body by M, N, K and dtype, the wgmma
    body's plan (tiles and K splits) at the flagship's sites and the
    edges, the CPU dispatch to the plain version bit for bit, the
    dequantization identity the wgmma body relies on, the refusals before
    any launch (a misaligned view among them), and the runtime's refusals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.generation.text import TextGenerationConfig as JGenCfg
from mm_interleaved_tpu.ops.quant import QDense
from mm_interleaved_tpu.ops.quant import quantize_int8 as j_quantize_int8
from mm_interleaved_tpu.ops.quant import (
    quantize_llm_weights as j_quantize_llm_weights)
from mm_interleaved_tpu.parallel.inference import (
    LocalGenerator as JLocalGenerator)
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig
from mm_interleaved_tpu_torch.models.llama import KVCache
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.ops import quant
from mm_interleaved_tpu_torch.ops.quant import (
    WGMMA_BN, WGMMA_ROWS, WGMMA_SPLITS, QLinear,
    dequantize_int8, int8_linear, int8_linear_body, int8_linear_cuda,
    int8_linear_plain, int8_linear_plan, int8_linear_vec, quantize_int8,
    quantize_llm_weights, wgmma_k)
from mm_interleaved_tpu_torch.parallel.inference import (
    build_generation_runtime, check_runtime)
from mm_interleaved_tpu_torch.utils.from_flax import (
    convert_variables, load_flax_params, load_flax_variables)

from _torch_parity import init_tiny, t

NEW = 6


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX model, noised params, the port's unquantized model,
    batch)."""
    cfg, jmodel, params, batch = init_tiny(scan_layers=True)
    model = build_model(tcfg.tiny_config(with_image_decoder=False), "cpu",
                        torch.float32)
    load_flax_params(model, params["params"])
    return cfg, jmodel, params, model.eval(), batch


def _port_model(params):
    model = build_model(tcfg.tiny_config(with_image_decoder=False), "cpu",
                        torch.float32)
    load_flax_params(model, params["params"])
    return model.eval()


@pytest.mark.parametrize("shape", [(64, 32), (3, 40, 24), (17, 5)])
def test_quantize_int8_bit_identical_to_jax(shape):
    """Codes and scales equal JAX's bit for bit in fp32: a plain kernel, a
    scanned stack (each block on its own) and a kernel with an all-zero
    output channel (the 1e-8 floor)."""
    rs = np.random.RandomState(sum(shape))
    w = (rs.randn(*shape) * rs.rand(*shape[:-2], 1, shape[-1]) * 3).astype(
        np.float32)
    w[..., 0] = 0.0
    jq, js = j_quantize_int8(jnp.asarray(w))
    q, s = quantize_int8(torch.from_numpy(np.swapaxes(w, -1, -2).copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.swapaxes(np.asarray(jq), -1,
                                                          -2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[..., 0, :])
    assert (q.numpy()[..., 0, :] == 0).all()


@pytest.mark.parametrize("bias", [True, False])
def test_qlinear_plain_matches_qdense(bias):
    """`QLinear`'s CPU path equals `QDense` with a ``qscale`` side-car
    within 1e-6, on [2, 3, K] activations."""
    rs = np.random.RandomState(3)
    K, N = 40, 24
    w = rs.randn(K, N).astype(np.float32) / np.sqrt(K)
    b = rs.randn(N).astype(np.float32)
    x = rs.randn(2, 3, K).astype(np.float32)
    jq, js = j_quantize_int8(jnp.asarray(w))
    params = {"kernel": jq}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = QDense(N, use_bias=bias).apply(
        {"params": params, "qscale": {"scale": js[0]}}, jnp.asarray(x))
    lin = torch.nn.Linear(K, N, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    ql = QLinear.from_linear(lin)
    got = ql(torch.from_numpy(x))
    assert got.shape == (2, 3, N)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_quantized_set_and_carried_tree_equal_jax(tiny):
    """The port quantizes exactly the layers JAX quantizes (the int8 leaves
    of JAX's tree, mapped by `from_flax`), and a JAX-quantized tree loaded
    into the port equals the port's own quantization of the same weights,
    codes, scales and every other tensor."""
    cfg, jmodel, params, _, _ = tiny
    qvars = j_quantize_llm_weights(params)
    carried = convert_variables(qvars)
    int8 = {k[:-len(".weight")] for k, v in carried.items()
            if v.dtype == torch.int8}
    own = _port_model(params)
    names = quantize_llm_weights(own)
    assert set(names) == int8
    assert {k for k in carried if k.endswith(".scale")} == \
        {f"{n}.scale" for n in names}
    assert any(n.startswith("text_decoder.head") for n in names)
    assert not any("llama_cross_attn" in n for n in names)
    loaded = build_model(tcfg.tiny_config(with_image_decoder=False), "cpu",
                         torch.float32)
    load_flax_variables(loaded, qvars)
    want = own.state_dict()
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="already quantized"):
        quantize_llm_weights(own)


def test_quantized_greedy_tokens_equal_jax(tiny):
    """Greedy tokens of the tiny model with ``quantize="int8"`` equal JAX's
    `LocalGenerator(quantize="int8")`; the quantized tokens are not
    compared with the unquantized ones."""
    cfg, jmodel, params, _, batch = tiny
    s = cfg.special
    kw = dict(max_new_tokens=NEW, pad_token_id=s.pad_token_id,
              eos_token_ids=(999,))
    jgen = JLocalGenerator(jmodel, params, quantize="int8")
    want = np.asarray(jgen.generate_texts(
        jnp.asarray(batch["text_ids"]), jnp.asarray(batch["image_tensors"]),
        jnp.asarray(batch["num_image_per_seq"]),
        jnp.asarray(batch["attention_mask"]), JGenCfg(**kw)))
    model = _port_model(params)
    runtime = build_generation_runtime(model, None, quantize="int8")
    assert isinstance(model.mm_decoder.layers[0].self_attn.q_proj, QLinear)
    got = runtime.generate_texts(
        t(batch["text_ids"]).long(), t(batch["image_tensors"]),
        t(batch["num_image_per_seq"]).long(),
        t(batch["attention_mask"]).long(), TextGenerationConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), want)


def _rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


def test_prefill_and_decode_track_the_unquantized_model(tiny):
    """The quantized LLM's prefill and decode-step hidden states stay
    within JAX's own bound, 0.05 relative, of the unquantized model's."""
    cfg, _, params, model, batch = tiny
    qmodel = _port_model(params)
    quantize_llm_weights(qmodel)
    ids = t(batch["text_ids"]).long()
    att = t(batch["attention_mask"]).long()
    outs = []
    with torch.inference_mode():
        for m in (model, qmodel):
            prep = m.prepare_mm_embeds(ids, t(batch["image_tensors"]),
                                       t(batch["num_image_per_seq"]).long())
            cache = KVCache.create(m.cfg.llm, 2, ids.shape[1] + 1)
            _, h_pre, cache, values = m.lm_prefill(
                prep["mm_embeds"], att, prep["mmfs_values"],
                prep["cross_attention_mask"], cache)
            logits, _ = m.lm_decode_step(
                ids[:, -1:], torch.ones(2, 1, dtype=torch.long), None,
                prep["cross_attention_mask"][:, -1:], cache, values)
            outs.append((h_pre, logits))
    assert _rel_err(outs[1][0], outs[0][0]) < 0.05
    assert _rel_err(outs[1][1], outs[0][1]) < 0.05
    assert _rel_err(outs[1][0], outs[0][0]) > 0  # the weights did change


def test_kernel_python_half_and_refusals(monkeypatch):
    """The body by M, N, K and dtype, the vector-load rule, the CPU
    dispatch to the plain version, and every refusal before any launch:
    inputs off the card, dtypes and shapes the kernel does not take, a view
    off a 16-byte boundary, an unknown quantize mode, a mesh (ROADMAP.md §1
    item 6)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    # bf16 with K % 16 == 0 (every LLM projection): the Hopper body
    assert [int8_linear_body(m, 5120, 5120, bf16)
            for m in (1, 2, 10, 16, 17, 512)] == ["wgmma"] * 6
    assert int8_linear_body(512, 2, 5120, bf16) == "wgmma"
    assert int8_linear_body(2, 5120, 16, bf16) == "wgmma"
    # K % 16 != 0 and fp32 keep their bodies
    assert int8_linear_body(3, 96, 200, bf16) == "gemv"
    assert int8_linear_body(40, 70, 200, bf16) == "mma"
    assert int8_linear_body(600, 64, 64, fp32) == "simt"
    assert int8_linear_body(8, 64, 64, fp32) == "gemv"
    assert int8_linear_body(8, 64, 200, fp32) == "gemv"
    with pytest.raises(TypeError):
        int8_linear_body(4, 64, 64, torch.float16)
    assert int8_linear_vec(5120) and int8_linear_vec(13824)
    assert not int8_linear_vec(40) and not int8_linear_vec(5121)

    rs = np.random.RandomState(0)
    q, s = quantize_int8(torch.from_numpy(rs.randn(8, 32).astype(np.float32)))
    x = torch.from_numpy(rs.randn(2, 3, 32).astype(np.float32))
    np.testing.assert_array_equal(int8_linear(x, q, s).numpy(),
                                  int8_linear_plain(x, q, s).numpy())

    launched = []
    monkeypatch.setattr(quant, "load_library",
                        lambda name: launched.append(name))
    x2 = x.reshape(6, 32)
    bad = [
        ((x2, q, s), ValueError, "one CUDA device"),
        ((x2[:, :16], q, s), ValueError, r"\[M, K\]"),
        ((x2, q.float(), s), TypeError, "int8"),
        ((x2, q, s.double()), TypeError, "fp32"),
        ((x2, q, s, torch.zeros(8, dtype=torch.bfloat16)), TypeError,
         "bias"),
        ((x2.half(), q, s), TypeError, "dtype"),
    ]
    for args, err, match in bad:
        with pytest.raises(err, match=match):
            int8_linear_cuda(*args)
    # past the device check, a view off a 16-byte boundary is refused
    monkeypatch.setattr(quant, "check_cuda", lambda *a, **k: None)
    flat = torch.zeros(6 * 32 + 1)
    with pytest.raises(ValueError, match="16-byte"):
        int8_linear_cuda(flat[1:].view(6, 32), q, s)
    assert launched == [] and int8_linear_cuda.launches == 0

    with pytest.raises(ValueError, match="unknown quantize mode"):
        check_runtime(None, "int4")
    with pytest.raises(NotImplementedError, match="item 6"):
        check_runtime({"tensor": 2}, "int8")


# the flagship's projection sites (M: decode B = 2, beams K = 3 and 5 at B
# = 2, the prefill and prefix forwards at 512 rows) and the kernel's edges
_PLAN_SITES = [(m, n, k) for m in (2, 6, 10, 512)
               for n, k in ((5120, 5120), (13824, 5120), (5120, 13824),
                            (32002, 5120), (2, 5120))] + [
    (m, 5120, 5120) for m in (1, 8, 9, 16, 17, 64, 65, 257)] + [
    (2, 130, 5120), (2, 5000, 5120), (512, 130, 5120), (2, 5120, 16),
    (2, 5120, 48), (2, 5120, 5136), (512, 5120, 5136), (3, 96, 208)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("M,N,K", _PLAN_SITES)
def test_int8_linear_plan_covers_the_product(M, N, K, sms):
    """`int8_linear_plan`: the K splits are disjoint, cover [0, K) in
    order, each a whole number of K tiles (the last may end at K) and none
    empty; the tiles cover N and M; the plan is one of the kernel's
    instances and the same on every call."""
    plan = int8_linear_plan(M, N, K, sms)
    assert plan["bn"] in WGMMA_BN
    assert plan["split"] in WGMMA_SPLITS
    tile = plan["k_tile"]
    assert tile == wgmma_k(plan["bn"]) and tile % 64 == 0
    kt = -(-K // tile)
    assert plan["k_tiles"] == kt and plan["split"] <= kt
    splits = plan["k_splits"]
    assert len(splits) == plan["split"]
    assert splits[0][0] == 0 and splits[-1][1] == K
    for (a0, a1), (b0, _) in zip(splits, splits[1:]):
        assert a1 == b0
    for k0, k1 in splits:
        assert k0 < k1
        assert k0 % tile == 0
        assert k1 % tile == 0 or k1 == K
    sizes = [-(-(k1 - k0) // tile) for k0, k1 in splits]
    assert sum(sizes) == kt and max(sizes) - min(sizes) <= 1
    assert (plan["n_tiles"] - 1) * WGMMA_ROWS < N <= \
        plan["n_tiles"] * WGMMA_ROWS
    assert (plan["m_tiles"] - 1) * plan["bn"] < M <= \
        plan["m_tiles"] * plan["bn"]
    int8_linear_plan.cache_clear()
    assert int8_linear_plan(M, N, K, sms) == plan
    assert int8_linear_plan(M, N, K, sms) is int8_linear_plan(M, N, K, sms)


def test_int8_linear_plan_refuses_empty():
    with pytest.raises(ValueError):
        int8_linear_plan(0, 5120, 5120)
    with pytest.raises(ValueError):
        int8_linear_plan(2, 5120, 5120, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_cpu_is_the_plain_version(dtype, bias):
    """On CPU tensors `int8_linear` (and `QLinear`) is the plain version,
    bit for bit, whatever the body a card would take; no launch."""
    rs = np.random.RandomState(5)
    w = torch.from_numpy(rs.randn(48, 64).astype(np.float32))
    q, s = quantize_int8(w)
    x = torch.from_numpy(rs.randn(2, 5, 64).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rs.randn(48).astype(np.float32)).to(dtype) \
        if bias else None
    before = int8_linear_cuda.launches
    got = int8_linear(x, q, s, b)
    want = int8_linear_plain(x, q, s, b)
    assert got.dtype == dtype and got.shape == (2, 5, 48)
    assert torch.equal(got, want)
    lin = torch.nn.Linear(64, 48, bias=bias).to(dtype)
    ql = QLinear.from_linear(lin)
    assert torch.equal(ql(x), int8_linear_plain(x, ql.weight, ql.scale,
                                                ql.bias))
    assert int8_linear_cuda.launches == before


@pytest.mark.parametrize("exp", [-30, -12, -5, 0, 3, 9])
def test_wgmma_dequant_identity(exp):
    """The wgmma body's dequantization, exactly as ``codes4_bf16`` computes
    it: ``fma(2^23 + (q ^ 0x80 as unsigned), s, -(2^23 + 128) s)`` in fp32
    (one rounding of an exact value), then one rounding to bf16, equals
    the plain version's ``q.to(bf16) * s.to(bf16)`` for every code and
    bf16 scales of every significand at magnitude 2^exp.  Emulated in
    float64, where the fma's product and sum are exact."""
    codes = np.arange(-127, 128, dtype=np.int64)
    sig = np.arange(128, 256, dtype=np.float64)  # every 8-bit significand
    s_bf16 = torch.from_numpy(sig * 2.0 ** (exp - 7)).to(torch.bfloat16)
    s = s_bf16.double().numpy()
    u = ((codes & 0xFF) ^ 0x80).astype(np.float64)  # the byte ^ 0x80
    f = 2.0 ** 23 + u                                 # the fp32 bit trick
    cs32 = np.float32(-(2.0 ** 23 + 128)) * s.astype(np.float32)
    assert np.array_equal(cs32.astype(np.float64), -(2.0 ** 23 + 128) * s)
    fma = (f[:, None] * s[None, :] + cs32.astype(np.float64)[None, :])
    assert np.array_equal(fma, codes[:, None] * s[None, :])  # exact
    got = torch.from_numpy(fma.T.astype(np.float32)).to(torch.bfloat16)
    # one weight row a scale, one column a code
    q = torch.from_numpy(codes.astype(np.int8))[None, :].expand(128, -1)
    want = dequantize_int8(q, s_bf16.float(), torch.bfloat16)
    assert torch.equal(got, want)


# the wgmma body's (x rows a tile, K splits) that served each flagship
# site fastest in a sweep of every pair on an H100 (PERF.md, PR 16), which
# `_plan_cost` is fitted to: (M, N, K) -> (bn, split)
_MEASURED_BEST = {
    (2, 5120, 5120): (8, 2), (2, 13824, 5120): (8, 1),
    (2, 5120, 13824): (8, 2), (2, 32002, 5120): (8, 1),
    (2, 2, 5120): (8, 8), (6, 5120, 5120): (8, 2),
    (10, 5120, 5120): (16, 2), (10, 13824, 5120): (16, 1),
    (10, 5120, 13824): (16, 2), (10, 32002, 5120): (16, 1),
    (512, 5120, 5120): (176, 1), (512, 13824, 5120): (256, 1),
    (512, 5120, 13824): (176, 1), (512, 32002, 5120): (256, 1),
    (512, 2, 5120): (64, 8),
}


@pytest.mark.parametrize("M,N,K", sorted(_MEASURED_BEST))
def test_int8_linear_plan_picks_the_measured_best(M, N, K):
    """At the flagship's sites on 132 SMs the plan is the pair the H100
    sweep measured fastest."""
    plan = int8_linear_plan(M, N, K, 132)
    assert (plan["bn"], plan["split"]) == _MEASURED_BEST[(M, N, K)]
