"""The training slice of the PyTorch port against the JAX package: labels
and the masked cross-entropy, the training losses and every trainable
gradient of `MMInterleaved.forward`, the freeze split, AdamW and its
schedules, gradient accumulation, the skip-nonfinite guard, checkpoints
and remat.

One JAX init of the tiny preset with its image decoder (``scan_layers=
False``), every leaf replaced by seeded noise (the zero-initialised gates
would hide the MMFS branches), carried over by `utils.from_flax`.  The
image decoder's random draws are the JAX package's own (the key split of
`ImageDecoder.__call__`), injected into the port.  JAX's loss and
gradients are computed once per module.  fp32 on the CPU; tolerances are
stated per test.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.engine import optim as jopt
from mm_interleaved_tpu.models import stream_ops as jso
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.engine import optim as topt
from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
from mm_interleaved_tpu_torch.models import stream_ops as tso
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.utils.from_flax import (
    convert_params, load_flax_params, port_name,
)

from _torch_parity import close, interleaved_batch, noised, t

OPTIM = dict(warmup_steps=0, total_steps=10)


def _configs(remat=False):
    out = []
    for mod in (j_tiny, tcfg.tiny_config):
        c = mod(scan_layers=False)
        out.append(dataclasses.replace(
            c, llm=dataclasses.replace(c.llm, remat=remat),
            image_decoder=dataclasses.replace(
                c.image_decoder, unet=dataclasses.replace(
                    c.image_decoder.unet, remat=remat))))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def _torch_batch(batch):
    out = {k: t(v) for k, v in batch.items()}
    for k in ("text_ids", "num_image_per_seq"):
        out[k] = out[k].long()
    return out


def _draws(jcfg, rng, n_rows):
    """The draws of `ImageDecoder.__call__` for ``rng``: VAE noise, noise,
    timesteps and uncond drops."""
    idc = jcfg.image_decoder
    n_img = n_rows * jcfg.max_num_images
    shape = (n_img, idc.latent_size, idc.latent_size,
             idc.vae.latent_channels)
    r_vae, r_noise, r_t, r_uncond = jax.random.split(rng, 4)
    return dict(
        vae_noise=t(jax.random.normal(r_vae, shape, jnp.float32)),
        noise=t(jax.random.normal(r_noise, shape, jnp.float32)),
        timesteps=t(jax.random.randint(
            r_t, (n_img,), 0, idc.schedule.num_train_timesteps)).long(),
        uncond_drop=t(jax.random.uniform(r_uncond, (n_img, 1, 1))
                      < idc.uncond_prob).reshape(-1),
    )


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = _configs()
    jmodel = MMInterleaved(jcfg)
    batch = interleaved_batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, **jb)
    params = noised(params, seed=1)["params"]
    # a key whose uncond draw drops some images and keeps others
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        draws = _draws(jcfg, rng, 2)
        if 0 < int(draws["uncond_drop"].sum()) < len(draws["uncond_drop"]):
            break

    def loss_fn(p):
        out = jmodel.apply({"params": p}, **jb, deterministic=False, rng=rng)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, batch=batch,
                draws=draws, jout=jout, jgrads=jgrads)


def _port_model(setup, pcfg=None, optim=None):
    model = build_model(pcfg or setup["pcfg"], "cpu", torch.float32,
                        optim=topt.OptimConfig(**(optim or OPTIM)))
    load_flax_params(model, setup["params"])
    return model


@pytest.fixture(scope="module")
def port_run(setup):
    model = _port_model(setup)
    out = model(**_torch_batch(setup["batch"]), **setup["draws"])
    out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return model, out, grads


def test_labels_and_cross_entropy_match_jax(setup):
    """`prepare_gt_text_ids` (prompt offsets as an int and per row, with
    and without ``ignore_noimage_cond_loss``) exactly, and
    `cross_entropy_ignore` within rtol 1e-6."""
    jcfg, batch = setup["jcfg"], setup["batch"]
    ids, att = batch["text_ids"], batch["attention_mask"]
    rs = np.random.RandomState(0)
    logits = rs.randn(2, ids.shape[1] - 1, 40).astype(np.float32)
    for offset in (0, 3, np.array([2, 7], np.int32)):
        for noimage in (False, True):
            want = jso.prepare_gt_text_ids(
                jnp.asarray(ids), jnp.asarray(att), jcfg.special.asdict(),
                ignore_prompt_token_offset=offset,
                ignore_noimage_cond_loss=noimage)
            got = tso.prepare_gt_text_ids(
                t(ids).long(), t(att), setup["pcfg"].special,
                ignore_prompt_token_offset=(t(offset) if isinstance(
                    offset, np.ndarray) else offset),
                ignore_noimage_cond_loss=noimage)
            close(got, want, 0, 0)
            labels = np.asarray(want) % 40 * (np.asarray(want) >= 0) + \
                np.asarray(want) * (np.asarray(want) < 0)
            close(tso.cross_entropy_ignore(t(logits), t(labels).long()),
                  jso.cross_entropy_ignore(jnp.asarray(logits),
                                           jnp.asarray(labels)), 1e-6, 0)
    none = np.full((2, 5), -100)
    assert float(tso.cross_entropy_ignore(t(logits[:, :5]),
                                          t(none).long())) == 0.0


def test_losses_match_jax(setup, port_run):
    """``loss``, ``loss_txt`` and ``loss_img`` of the training forward
    (``deterministic=False``, JAX's own draws injected), rtol 1e-5."""
    _, out, _ = port_run
    jout = setup["jout"]
    assert 0 < int(setup["draws"]["uncond_drop"].sum()) < 6
    for k in ("loss", "loss_txt", "loss_img"):
        close(out[k], jout[k], 1e-5, 0)


def test_trainable_grads_match_jax(setup, port_run):
    """Every trainable leaf's gradient, carried over by `convert_params`,
    within 1e-4 x its scale: the larger of the leaf's largest gradient and
    1e-3 of the largest of all (a leaf whose exact gradient vanishes, as
    the key LayerNorm bias's does under softmax's shift invariance, holds
    rounding noise only).  Every gradient the JAX trainer would apply
    reaches the port (the MMFS branches, the deformable value projections
    and offsets included)."""
    _, _, grads = port_run
    want = convert_params(setup["jgrads"])
    assert set(grads) <= set(want)
    top = max(float(want[n].abs().max()) for n in grads)
    live = 0
    for name, g in grads.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        live += float(np.abs(w).max()) > 1e-6 * top
    assert live > 0.9 * len(grads)
    for key in ("image_decoder.unet.mmfs_net.mid_block.mmfs.value_proj.weight",
                "mm_decoder.layers.0.llama_cross_attn.attn.sampling_offsets"
                ".weight",
                "visual_tokenizer.encoder.injectors.0.attn.value_proj.weight"):
        assert float(grads[key].abs().max()) > 0, key


def test_freeze_split_matches_label_for_path(setup, port_run):
    """The port's labels, from a walk of its module tree, equal the JAX
    `label_for_path` of every leaf mapped through the path converter; the
    frozen leaves have ``requires_grad=False``."""
    model = port_run[0]
    cfg_j, cfg_t = jopt.OptimConfig(), topt.OptimConfig()
    want = {port_name(p): jopt.label_for_path(p, cfg_j)
            for p in _flat(setup["params"])}
    got = topt.param_labels(model, cfg_t)
    assert got == want
    assert {n: p.requires_grad for n, p in model.named_parameters()} == \
        {n: lab != "frozen" for n, lab in want.items()}
    assert set(want.values()) == {"frozen", "default", "group_0", "group_1",
                                  "group_2", "group_3"}


def test_optim_config_matches_jax_field_for_field():
    """`OptimConfig`: the same fields, defaults, param groups and frozen
    patterns as the JAX package's."""
    assert dataclasses.asdict(topt.OptimConfig()) == \
        dataclasses.asdict(jopt.OptimConfig())
    assert [f.name for f in dataclasses.fields(topt.OptimConfig)] == \
        [f.name for f in dataclasses.fields(jopt.OptimConfig)]


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedules_match_optax(kind):
    for warm, total, ratio in ((3, 10, 0.0), (0, 8, 0.1), (5, 1000, 0.2)):
        kw = dict(schedule=kind, warmup_steps=warm, total_steps=total,
                  min_lr_ratio=ratio, learning_rate=3e-4)
        want = jopt.make_schedule(jopt.OptimConfig(**kw))
        got = topt.make_schedule(topt.OptimConfig(**kw))
        for step in (0, 1, warm, warm + 1, total // 2, total, total + 5):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=1e-12)


def test_adamw_steps_match_optax(setup):
    """Two AdamW updates with JAX's gradients (frozen leaves zeroed, so the
    clip norm runs over the same leaves) against `make_optimizer`'s
    ``tx.update``: every parameter within 1e-6, frozen ones unchanged."""
    params, jgrads = setup["params"], setup["jgrads"]
    kw = dict(warmup_steps=0, total_steps=10)
    jcfg = jopt.OptimConfig(**kw)
    labels = jax.tree_util.tree_map(
        lambda p: jopt.label_for_path(p, jcfg), jopt.path_strings(params))
    grads = jax.tree_util.tree_map(
        lambda g, lab: g * 0 if lab == "frozen" else g, jgrads, labels)
    tx = jopt.make_optimizer(jcfg, params)
    state = tx.init(params)
    update = jax.jit(tx.update)
    p_j = params
    for _ in range(2):
        upd, state = update(grads, state, p_j)
        p_j = optax.apply_updates(p_j, upd)
    want = convert_params(p_j)

    model = _port_model(setup, optim=kw)
    tr = Trainer(model, TrainerConfig(optim=topt.OptimConfig(**kw)), "cpu")
    g_t = convert_params(grads)
    named = dict(model.named_parameters())
    for _ in range(2):
        gl = [g_t[n].clone() for n in tr.optimizer.names]
        norm = torch.sqrt(sum((g * g).sum() for g in gl))
        tr.optimizer.step(gl, norm)
    assert tr.optimizer.count == 2
    before = convert_params(params)
    for n, p in named.items():
        close(p.detach(), want[n], 0, 1e-6)
        if not p.requires_grad:
            assert torch.equal(p.detach(), before[n]), n


def _two_row_micro_batches(setup):
    """Micro-batches (r0, r1) and (r1, r0) with their draws, and the same
    four rows as one batch with the concatenated draws."""
    b = _torch_batch(setup["batch"])
    d0 = setup["draws"]
    d1 = _draws(setup["jcfg"], jax.random.PRNGKey(1234), 2)
    swap = {k: v.flip(0) for k, v in b.items()}
    stacked = {k: torch.stack([b[k], swap[k]]) for k in b}
    four = {k: torch.cat([b[k], swap[k]]) for k in b}
    cat = {k: torch.cat([d0[k], d1[k]]) for k in d0}
    return stacked, [d0, d1], four, [cat]


def test_grad_accumulation_equals_one_batch(setup):
    """Two micro-batches of two rows, accumulated, against one batch of the
    same four rows (equal token and image counts per micro-batch, so the
    mean losses agree): loss within rtol 1e-5, parameters after the step
    within 1e-6."""
    stacked, draws2, four, draws1 = _two_row_micro_batches(setup)
    outs = []
    for n, batch, draws in ((2, stacked, draws2), (1, four, draws1)):
        model = _port_model(setup)
        tr = Trainer(model, TrainerConfig(
            optim=topt.OptimConfig(**OPTIM), grad_accum_steps=n), "cpu")
        metrics = tr.train_step(batch, draws)
        outs.append((metrics, dict(model.named_parameters())))
    (m2, p2), (m1, p1) = outs
    for k in ("loss", "loss_txt", "loss_img", "grad_norm"):
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-5)
    for n in p1:
        close(p2[n].detach(), p1[n].detach(), 0, 1e-6)


def test_nonfinite_loss_skips_the_update(setup):
    """A NaN in the image targets makes the loss NaN: the parameters, the
    moments and the update count (the schedule's) stay as they were; the
    step counter advances."""
    model = _port_model(setup)
    tr = Trainer(model, TrainerConfig(optim=topt.OptimConfig(**OPTIM)),
                 "cpu")
    b = _torch_batch(setup["batch"])
    tr.train_step(b, [setup["draws"]])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = [x.clone() for x in tr.optimizer.m]
    count = tr.optimizer.count
    bad = dict(b, image_tensors_dec=b["image_tensors_dec"].clone())
    bad["image_tensors_dec"][0, 0, 0, 0, 0] = float("nan")
    metrics = tr.train_step(bad, [setup["draws"]])
    assert not np.isfinite(metrics["loss"])
    assert tr.optimizer.count == count and tr.step == 2
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    for a, b_ in zip(tr.optimizer.m, m):
        assert torch.equal(a, b_)


def test_checkpoint_round_trip_is_bit_identical(setup, tmp_path):
    """Save after step 1, take step 2; a fresh model restored from the
    checkpoint takes a bit-identical step 2 (parameters, moments, count,
    step, the numpy RNG state and the data state)."""
    b = _torch_batch(setup["batch"])
    cfg = TrainerConfig(optim=topt.OptimConfig(**OPTIM), save_every=1,
                        checkpoint_dir=str(tmp_path))
    model = _port_model(setup)
    tr = Trainer(model, cfg, "cpu")
    tr.train_step(b)
    np.random.seed(7)
    path = tr.maybe_save(data_state={"epoch": 1, "offset": 5})
    assert path is not None and path.exists()
    rng_after_save = np.random.rand()
    m_a = tr.train_step(b)
    p_a = {n: p.detach().clone() for n, p in model.named_parameters()}

    class It:
        state_seen = None

        def restore(self, state):
            It.state_seen = state

    model2 = _port_model(setup)
    tr2 = Trainer(model2, cfg, "cpu")
    assert tr2.restore(It())
    assert It.state_seen == {"epoch": 1, "offset": 5}
    assert tr2.step == 1 and tr2.optimizer.count == 1
    assert np.random.rand() == rng_after_save
    m_b = tr2.train_step(b)
    assert m_a == m_b
    for n, p in model2.named_parameters():
        assert torch.equal(p.detach(), p_a[n]), n


def test_remat_gives_the_same_loss_and_grads(setup, port_run):
    """``remat`` on the decoder layers and the UNet blocks: the same loss
    and gradients (rtol 1e-6; the recompute runs the same ops)."""
    _, out, grads = port_run
    pcfg = _configs(remat=True)[1]
    assert pcfg.llm.remat and pcfg.image_decoder.unet.remat
    model = _port_model(setup, pcfg=pcfg)
    out_r = model(**_torch_batch(setup["batch"]), **setup["draws"])
    out_r["loss"].backward()
    close(out_r["loss"], out["loss"].detach(), 1e-6, 0)
    for n, p in model.named_parameters():
        if p.requires_grad:
            close(p.grad, grads[n], 1e-6, 1e-9)


def test_fit_logs_and_saves_the_data_position(setup, tmp_path):
    """`Trainer.fit` over an iterator with a data position: it logs at
    ``log_every`` and at the end, and each checkpoint holds the position the
    iterator reported after that step."""
    b = _torch_batch(setup["batch"])

    class Batches:
        def __init__(self):
            self.offset = 0

        def __next__(self):
            self.offset += 1
            return b

        def state(self):
            return {"epoch": 0, "offset": self.offset}

    cfg = TrainerConfig(optim=topt.OptimConfig(**OPTIM), log_every=2,
                        save_every=2, keep_checkpoints=1,
                        checkpoint_dir=str(tmp_path))
    tr = Trainer(_port_model(setup), cfg, "cpu")
    logged = []
    tr.fit(Batches(), num_steps=3, log_fn=lambda step, m: logged.append(
        (step, sorted(m))))
    assert [step for step, _ in logged] == [2, 3]
    assert logged[0][1] == ["grad_norm", "loss", "loss_img", "loss_txt",
                            "steps_per_sec"]
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == ["step_2.pt"]
    state = torch.load(tmp_path / "step_2.pt", weights_only=False)
    assert state["step"] == 2 and state["data_state"] == {"epoch": 0,
                                                          "offset": 2}
