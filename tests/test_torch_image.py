"""The image slice of the PyTorch port against the JAX package: the image
decoder's modules, the weight bridge with the image decoder, and
`generate_image_inputs` -> `generate_images` end to end.

One JAX init of the tiny preset with its image decoder (``scan_layers=
False``, the VAE decoding in fp32 on both sides) whose every leaf is
seeded noise: the MMFSBlock convs, the MMFS offset kernels and ignore
tokens initialise at zero and would hide the whole MMFS branch.  The batch
is tests/test_mm_interleaved.py's with row 1 holding two images in one
document, so one target image has a previous image (``mmfs_mask`` not all
zero).  fp32 on the CPU; tolerances are stated per test.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.generation.diffusion import (
    compute_mmfs_projections, generate_images as j_generate_images,
)
from mm_interleaved_tpu.models import stream_ops as jso
from mm_interleaved_tpu.models.llama import stack_llama_layers
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu.models.perceiver import PerceiverResampler as JPerc
from mm_interleaved_tpu.models.sd import mmfs_net as jmn
from mm_interleaved_tpu.models.sd import unet as jun
from mm_interleaved_tpu.models.sd.vae import AutoencoderKL as JVAE
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.generation.diffusion import generate_images
from mm_interleaved_tpu_torch.models import stream_ops as tso
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.models.perceiver import PerceiverResampler
from mm_interleaved_tpu_torch.models.sd import mmfs_net as tmn
from mm_interleaved_tpu_torch.models.sd import unet as tun
from mm_interleaved_tpu_torch.models.sd.vae import AutoencoderKL
from mm_interleaved_tpu_torch.utils.from_flax import (
    convert_params, load_flax_params,
)

from _torch_parity import close, noised, t

RTOL = 1e-4


def _configs(scan_layers=False):
    out = []
    for mod in (j_tiny, tcfg.tiny_config):
        c = mod(scan_layers=scan_layers)
        out.append(dataclasses.replace(c, image_decoder=dataclasses.replace(
            c.image_decoder, vae_decode_dtype="float32")))
    return out


def _batch(cfg, L=40, max_img=3, seed=0):
    S = cfg.special
    n_tok = cfg.num_img_token

    def row(docs):
        r = []
        for doc in docs:
            r.append(S.bos_token_id)
            for x in doc:
                r += ([S.soi_token_id] + [S.image_token_id] * n_tok
                      if x == "I" else [x])
            r.append(S.eos_token_id)
        return r + [S.pad_token_id] * (L - len(r))

    rng = np.random.RandomState(seed)
    ids = np.array([row([[5, 6, "I", 7], [8, "I", 9, 10]]),
                    row([[11, "I", 12, "I", 13, 14]])], np.int32)
    return dict(
        text_ids=ids,
        image_tensors=rng.rand(2, max_img, 56, 56, 3).astype(np.float32),
        num_image_per_seq=np.array([2, 2], np.int32),
        attention_mask=(ids != S.pad_token_id).astype(np.int32),
        image_tensors_dec=rng.rand(2, max_img, 16, 16, 3).astype(np.float32),
    )


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = _configs()
    jmodel = MMInterleaved(jcfg)
    batch = _batch(jcfg)
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        **{k: jnp.asarray(v) for k, v in batch.items()},
    )
    params = noised(params, seed=1)
    model = build_model(pcfg, "cpu", torch.float32)
    load_flax_params(model, params["params"])
    return jcfg, pcfg, jmodel, params, model, batch


def _p(setup, *path):
    sub = setup[3]["params"]
    for k in path:
        sub = sub[k]
    return sub


def _port(module, params):
    load_flax_params(module, params)
    return module.eval()


def test_bridge_loads_image_decoder_strict_in_both_layouts(setup):
    """The full tiny model with its image decoder loads strictly from the
    unrolled tree, and the scan_layers tree converts to the same dict."""
    jcfg, pcfg, _, params, model, _ = setup
    p = params["params"]
    flat = convert_params(p)
    stacked = dict(p)
    stacked["mm_decoder"] = stack_llama_layers(
        p["mm_decoder"], jcfg.llm.num_hidden_layers,
        jcfg.llm.cross_attention_frequency)
    flat_s = convert_params(stacked)
    assert flat.keys() == flat_s.keys()
    for k in flat:
        assert torch.equal(flat[k], flat_s[k]), k
    scanned = build_model(_configs(scan_layers=True)[1], "cpu",
                          torch.float32)
    scanned.load_state_dict(flat_s, strict=True)
    w = p["image_decoder"]["unet"]["conv_in"]["kernel"]
    assert torch.equal(flat["image_decoder.unet.conv_in.weight"],
                       t(np.transpose(w, (3, 2, 0, 1))))
    assert torch.equal(model.image_decoder.neg_prompt_embeds,
                       t(p["image_decoder"]["neg_prompt_embeds"]))


def test_scheduler_tables_and_steps_match_jax(setup):
    jsch = setup[0].image_decoder.schedule
    tsch = setup[1].image_decoder.schedule
    close(tsch.alphas_cumprod(), jsch.alphas_cumprod(), 1e-6, 0)
    for n in (3, 7):
        assert tsch.inference_timesteps(n) == \
            np.asarray(jsch.inference_timesteps(n)).tolist()
    rs = np.random.RandomState(0)
    out, x, noise = (rs.randn(2, 4, 4, 4).astype(np.float32)
                     for _ in range(3))
    for t_, tp in ((66, 33), (33, 0), (0, -1)):
        want = jsch.ddpm_step(jnp.asarray(out), t_, tp, jnp.asarray(x),
                              jnp.asarray(noise))
        close(tsch.ddpm_step(t(out), t_, tp, t(x), t(noise)), want, 1e-5,
              1e-6)
        want = jsch.ddim_step(jnp.asarray(out), t_, tp, jnp.asarray(x))
        close(tsch.ddim_step(t(out), t_, tp, t(x)), want, 1e-5, 1e-6)
    ts = np.array([3, 50, 99])
    close(tsch.add_noise(t(x[:1].repeat(3, 0)), t(noise[:1].repeat(3, 0)),
                         t(ts)),
          jsch.add_noise(jnp.asarray(x[:1].repeat(3, 0)),
                         jnp.asarray(noise[:1].repeat(3, 0)),
                         jnp.asarray(ts)), 1e-5, 1e-6)


def test_timestep_embedding_matches_jax():
    ts = np.array([0, 1, 17, 999], np.int32)
    close(tun.timestep_embedding(t(ts), 32),
          jun.timestep_embedding(jnp.asarray(ts), 32), 1e-5, 1e-5)


def test_resnet_and_transformer_blocks(setup):
    """UNet ResnetBlock (with a shortcut), TransformerBlock and
    SpatialTransformer on their params subtrees.  rtol 1e-4."""
    pcfg = setup[1].image_decoder.unet
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 4, 16).astype(np.float32)
    temb = rs.randn(2, 64).astype(np.float32)
    sub = _p(setup, "image_decoder", "unet", "down_1_res_0")
    want = jun.ResnetBlock(32, 4).apply({"params": sub}, jnp.asarray(x),
                                        jnp.asarray(temb))
    got = _port(tun.ResnetBlock(16, 32, 64, 4), sub)(t(x), t(temb))
    close(got, want, RTOL, 1e-5)

    ctx = rs.randn(2, 5, 16).astype(np.float32)
    sub = _p(setup, "image_decoder", "unet", "down_0_attn_0")
    want = jun.SpatialTransformer(2, 16, 4).apply(
        {"params": sub}, jnp.asarray(x), jnp.asarray(ctx))
    got = _port(tun.SpatialTransformer(16, 2, pcfg.cross_attention_dim, 4),
                sub)(t(x), t(ctx))
    close(got, want, RTOL, 1e-5)

    h = x.reshape(2, 16, 16)
    want = jun.TransformerBlock(16, 2, 16).apply(
        {"params": sub["block"]}, jnp.asarray(h), jnp.asarray(ctx))
    got = _port(tun.TransformerBlock(16, 2, 16), sub["block"])(t(h), t(ctx))
    close(got, want, RTOL, 1e-5)


def _mmfs_inputs(cfg, seed=6):
    rs = np.random.RandomState(seed)
    m = cfg.image_decoder.unet.mmfs
    hw = sum(s * s for s in m.feat_spatial_shapes)
    values = rs.randn(2, 2, hw, m.input_channel).astype(np.float32)
    mask = np.array([[1, 0], [0, 1]], np.int32)  # one live, one masked
    return values, mask


def test_mmfs_block_and_net(setup):
    """MMFSBlock and MMFSNet (UNet branch, per-image masks) on the same
    weights; `project_values` against the JAX denoise loop's
    `compute_mmfs_projections`.  rtol 1e-4."""
    jcfg, pcfg = setup[0], setup[1]
    ucfg_j, ucfg_t = jcfg.image_decoder.unet, pcfg.image_decoder.unet
    values, mask = _mmfs_inputs(jcfg)
    rs = np.random.RandomState(7)
    sub = _p(setup, "image_decoder", "unet", "mmfs_net")
    sample = rs.randn(2, 4, 4, 16).astype(np.float32)
    want = jmn.MMFSBlock(ucfg_j.mmfs, 16, 4).apply(
        {"params": sub["down_blocks_0"]}, jnp.asarray(sample),
        jnp.asarray(values), jnp.asarray(mask))
    blk = _port(tmn.MMFSBlock(ucfg_t.mmfs, 16, 4), sub["down_blocks_0"])
    got = blk(t(sample), blk.prepare(t(values), t(mask)))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # the branch is live
    close(got, want, RTOL, 1e-5)

    chans, sizes = ucfg_j.down_residual_spec()
    assert (chans, sizes) == ucfg_t.down_residual_spec()
    res = tuple(rs.randn(2, s, s, c).astype(np.float32)
                for c, s in zip(chans, sizes))
    mid = rs.randn(2, sizes[-1], sizes[-1], 32).astype(np.float32)
    jnet = jmn.MMFSNet(ucfg_j.mmfs, chans, sizes, 32, sizes[-1])
    want_mid, want_res = jnet.apply(
        {"params": sub}, jnp.asarray(mid), tuple(map(jnp.asarray, res)),
        jnp.asarray(values), jnp.asarray(mask))
    net = _port(tmn.MMFSNet(ucfg_t.mmfs, chans, sizes, 32, sizes[-1]), sub)
    prepared = net.prepare(t(values), t(mask))
    got_mid, got_res = net(t(mid), tuple(map(t, res)), prepared)
    close(got_mid, want_mid, RTOL, 1e-5)
    for a, b in zip(got_res, want_res):
        close(a, b, RTOL, 1e-5)
    # the image side of the pre-CFG batch serves both CFG halves
    cfg_mid, _ = net(t(mid).repeat(2, 1, 1, 1),
                     tuple(t(r).repeat(2, 1, 1, 1) for r in res), prepared)
    close(cfg_mid[:2], got_mid, 0, 1e-6)
    close(cfg_mid[2:], got_mid, 0, 1e-6)

    want = compute_mmfs_projections(
        setup[2], setup[3], lambda m: m.image_decoder, ucfg_j,
        jnp.asarray(values), jnp.asarray(mask))
    got = net.project_values(t(values))
    assert len(got) == len(want) == len(chans) + 1
    for a, b in zip(got, want):
        close(a, b, RTOL, 1e-5)


def test_unet_with_mmfs(setup):
    """The tiny UNet with MMFS (one masked, one live previous image).
    rtol 1e-4."""
    jcfg, pcfg, _, params, model, _ = setup
    values, mask = _mmfs_inputs(jcfg)
    rs = np.random.RandomState(8)
    n = jcfg.image_decoder.unet.sample_size
    x = rs.randn(2, n, n, 4).astype(np.float32)
    ts = np.array([3, 71], np.int32)
    ctx = rs.randn(2, 5, 16).astype(np.float32)
    sub = _p(setup, "image_decoder", "unet")
    want = jun.UNet2DConditionModel(jcfg.image_decoder.unet).apply(
        {"params": sub}, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(ctx),
        jnp.asarray(values), jnp.asarray(mask))
    unet = model.image_decoder.unet
    got = unet(t(x), t(ts), t(ctx), t(values), t(mask))
    close(got, want, RTOL, 1e-4)


def test_vae_decode_and_encode(setup):
    """VAE decode, and encode with ``sample=False``.  rtol 1e-4."""
    jcfg = setup[0]
    rs = np.random.RandomState(9)
    sub = _p(setup, "image_decoder", "vae")
    vae_j = JVAE(jcfg.image_decoder.vae)
    vae_t = setup[4].image_decoder.vae
    z = rs.randn(2, 4, 4, 4).astype(np.float32)
    want = vae_j.apply({"params": sub}, jnp.asarray(z), method=JVAE.decode)
    close(vae_t.decode(t(z)), want, RTOL, 1e-4)
    x = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = vae_j.apply({"params": sub}, jnp.asarray(x), sample=False,
                       method=JVAE.encode)
    close(vae_t.encode(t(x), sample=False), want, RTOL, 1e-4)


def test_resample_context_with_mask(setup):
    """The image decoder's perceiver with its context mask, and the
    (cond, neg) pair of `resample_context`.  rtol 1e-4."""
    jcfg = setup[0]
    rs = np.random.RandomState(10)
    feats = rs.randn(2, 7, 32).astype(np.float32)
    mask = np.ones((2, 7), np.int32)
    mask[1, 3:] = 0
    sub = _p(setup, "image_decoder", "perceiver_resampler")
    want = JPerc(jcfg.image_decoder.perceiver).apply(
        {"params": sub}, jnp.asarray(feats), jnp.asarray(mask))
    dec = setup[4].image_decoder
    ctx, neg = dec.resample_context(t(feats), t(mask))
    close(ctx, want, RTOL, 1e-5)
    assert neg.shape == ctx.shape
    close(neg[1], _p(setup, "image_decoder", "neg_prompt_embeds")[0], 0, 0)
    port = _port(PerceiverResampler(setup[1].image_decoder.perceiver), sub)
    close(port(t(feats), t(mask)), want, RTOL, 1e-5)


def test_context_windows_and_previous_image_mask():
    """Exact integer ops, and the window gather bit for bit."""
    rs = np.random.RandomState(11)
    B, L, max_img, C = 2, 20, 3, 4
    ids = rs.randint(3, 100, (B, L)).astype(np.int32)
    ids[0, [0, 9]] = 1  # two documents in row 0
    ids[1, 0] = 1
    ids[0, [3, 12]] = 121
    ids[1, [2, 6, 15]] = 121
    n_img = np.array([2, 3], np.int32)
    hidden = rs.randn(B, L, C).astype(np.float32)
    soi = jso.token_positions(jnp.asarray(ids), 121, max_img)
    bos = jso.nearest_bos_positions(jnp.asarray(ids), 1)
    for max_ctx in (4, 16):
        want = jso.context_windows(jnp.asarray(hidden), soi, bos,
                                   jnp.asarray(n_img), max_ctx)
        got = tso.context_windows(t(hidden), t(soi).long(), t(bos).long(),
                                  t(n_img).long(), max_ctx)
        for a, b in zip(got, want):
            close(a, b, 0, 0)
    want = jso.previous_image_mask(soi, bos, jnp.asarray(n_img), L)
    got = tso.previous_image_mask(t(soi).long(), t(bos).long(),
                                  t(n_img).long(), L)
    close(got, want, 0, 0)
    assert np.asarray(want).tolist() == [[0, 0, 0], [0, 1, 1]]


@pytest.fixture(scope="module")
def inputs(setup):
    jcfg, _, jmodel, params, model, batch = setup
    jb = [jnp.asarray(batch[k]) for k in ("text_ids", "image_tensors",
                                          "num_image_per_seq",
                                          "attention_mask")]
    want = jmodel.apply(params, *jb,
                        method=MMInterleaved.generate_image_inputs)
    tb = [t(batch["text_ids"]).long(), t(batch["image_tensors"]),
          t(batch["num_image_per_seq"]).long(), t(batch["attention_mask"])]
    got = model.generate_image_inputs(*tb)
    return want, got


def test_generate_image_inputs_match_jax(inputs):
    """Context windows, their mask, the previous-image pyramid and its
    mask: all four outputs (rtol 1e-4 on the features, exact masks)."""
    want, got = inputs
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    close(got[0], want[0], RTOL, 1e-4)
    close(got[1], want[1], 0, 0)
    close(got[2], want[2], RTOL, 1e-4)
    close(got[3], want[3], 0, 0)
    assert np.asarray(want[3]).ravel().tolist() == [0, 0, 0, 0, 1, 0]


def test_generate_images_match_jax(setup, inputs):
    """3 DDPM steps with guidance 2.0 on the generated inputs; the port is
    fed JAX's own latents and per-step noise (the key sequence of
    `generate_images`).  Images within atol 1e-4."""
    jcfg, _, jmodel, params, model, _ = setup
    want_in, got_in = inputs
    steps, rng = 3, jax.random.PRNGKey(4)
    want = j_generate_images(jmodel, params, want_in[0], want_in[1], rng,
                             mmfs_values=want_in[2], mmfs_mask=want_in[3],
                             num_inference_steps=steps, guidance_scale=2.0)
    idc = jcfg.image_decoder
    shape = (want_in[0].shape[0], idc.latent_size, idc.latent_size,
             idc.vae.latent_channels)
    r, r_init = jax.random.split(rng)
    latents = jax.random.normal(r_init, shape, jnp.float32)
    noises = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                       for k in jax.random.split(r, steps)])
    got = generate_images(model, got_in[0], got_in[1], got_in[2], got_in[3],
                          num_inference_steps=steps, guidance_scale=2.0,
                          latents=t(latents), noises=t(noises))
    assert tuple(got.shape) == want.shape == (6, 16, 16, 3)
    close(got, want, 0, 1e-4)
