"""The port's entry points on the CPU: the training entry point
(`mm_interleaved_tpu_torch.train`) with its data layer, and the two
benchmarks (`bench`, `bench_train`), against the JAX package where both
compute the same thing.

* The first batch of both pipelines through one training step of each
  side (tiny preset with its image decoder, fp32, JAX's noised init carried
  over by `utils.from_flax`, JAX's own draws injected): losses within rtol
  1e-5, every trainable gradient within 1e-4 of its scale, as
  tests/test_torch_train.py holds them.
* `train.main --device cpu`: finite step lines and a checkpoint; a run
  interrupted in step 3 and resumed from its step-2 checkpoint takes the
  same batch and gives the same step 3, bit for bit, as an uninterrupted
  run (the prefetching thread runs ahead of the consumed position); the
  settings the port refuses raise.
* `bench.make_batch` is `bench.py`'s recipe for ``RandomState(0)``;
  `bench.text_half` gives JAX's greedy tokens at the tiny preset; both
  benchmarks print one JSON line with the JAX line's keys, and a failure
  inside a section propagates.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from mm_interleaved_tpu.configs import base_config as j_base
from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.data.pipeline import (
    build_train_iterator as j_build_train_iterator,
)
from mm_interleaved_tpu.generation.text import (
    TextGenerationConfig as JGenCfg, generate_texts as j_generate_texts,
)
from mm_interleaved_tpu.models.mm_interleaved import MMInterleaved
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch import bench, bench_train, train
from mm_interleaved_tpu_torch.data.pipeline import (
    build_train_iterator as t_build_train_iterator,
)
from mm_interleaved_tpu_torch.engine import optim as topt
from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.utils.device import to_device
from mm_interleaved_tpu_torch.utils.from_flax import (
    convert_params, load_flax_params,
)

from _torch_parity import close, noised
from test_torch_train import OPTIM, _configs, _draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = os.path.join(ROOT, "configs", "pretrain_synthetic.yaml")
DATA = {"per_device_batch_size": 2, "seed": 0,
        "datasets": [{"name": "synthetic", "num_samples": 16}]}


def noised_init(model, batch, seed=1):
    """JAX's variables for ``batch``, every leaf seeded noise: the shapes
    come from `jax.eval_shape` (nothing compiles) and `noised` replaces
    the values whatever they were."""
    shapes = jax.eval_shape(
        model.init, {"params": jax.random.PRNGKey(0),
                     "noise": jax.random.PRNGKey(1),
                     "dropout": jax.random.PRNGKey(2)},
        **{k: jnp.asarray(v) for k, v in batch.items()})
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    return noised(zeros, seed=seed)


# --------------------------------------------------------------------------
# the pipeline's first batch through one training step of each side


@pytest.fixture(scope="module")
def pipeline_step():
    jcfg, pcfg = _configs()
    _, j_first = j_build_train_iterator(DATA, jcfg)
    _, t_first = t_build_train_iterator(DATA, pcfg)
    jmodel = MMInterleaved(jcfg)
    params = noised_init(jmodel, j_first)["params"]
    # a key whose uncond draw drops some images and keeps others
    for seed in range(100):
        rng = jax.random.PRNGKey(seed)
        draws = _draws(jcfg, rng, 2)
        if 0 < int(draws["uncond_drop"].sum()) < len(draws["uncond_drop"]):
            break
    jb = {k: jnp.asarray(v) for k, v in j_first.items()}

    def loss_fn(p):
        out = jmodel.apply({"params": p}, **jb, deterministic=False, rng=rng)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return dict(pcfg=pcfg, params=params, t_first=t_first, draws=draws,
                jout=jout, jgrads=convert_params(jgrads))


def test_pipeline_batch_trains_as_in_jax(pipeline_step):
    """The port's first batch (`to_device`) through
    `MMInterleaved.forward` and its backward, then `Trainer.train_step`,
    against JAX's first batch through `jax.value_and_grad`: the losses
    within rtol 1e-5, every trainable gradient within 1e-4 of its scale
    (tests/test_torch_train.py's tolerances), the step's gradient norm
    within rtol 1e-5 of JAX's over the same leaves."""
    s = pipeline_step
    model = build_model(s["pcfg"], "cpu", torch.float32,
                        optim=topt.OptimConfig(**OPTIM))
    load_flax_params(model, s["params"])
    batch = to_device(s["t_first"], "cpu")
    assert batch["text_ids"].dtype == torch.int64
    assert batch["image_tensors_dec"].dtype == torch.float32
    out = model(**batch, **s["draws"])
    out["loss"].backward()
    for k in ("loss", "loss_txt", "loss_img"):
        close(out[k].detach(), s["jout"][k], 1e-5, 0)
    want = s["jgrads"]
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.requires_grad}
    top = max(float(want[n].abs().max()) for n in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    norm = float(np.sqrt(sum(float((want[n].double() ** 2).sum())
                             for n in grads)))
    model.zero_grad(set_to_none=True)
    tr = Trainer(model, TrainerConfig(optim=topt.OptimConfig(**OPTIM)),
                 "cpu")
    m = tr.train_step(batch, [s["draws"]])
    np.testing.assert_allclose(m["loss"], float(s["jout"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], norm, rtol=1e-5)


# --------------------------------------------------------------------------
# the training entry point


def write_config(tmp_path, name="cfg.yaml", **sections):
    """`configs/pretrain_synthetic.yaml` with each section's keys
    updated."""
    with open(SYNTHETIC) as f:
        cfg = yaml.safe_load(f)
    for sec, kv in sections.items():
        cfg.setdefault(sec, {}).update(kv)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def step_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("step ")]


def test_train_main_runs_on_the_cpu(tmp_path, capsys):
    """3 step lines with finite losses, the parameter counts, the dumped
    config and a final checkpoint."""
    out = tmp_path / "run"
    res = train.main(["--config", write_config(tmp_path), "--output_dir",
                      str(out), "--device", "cpu", "--max_steps", "3"])
    text = capsys.readouterr().out
    lines = step_lines(text)
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2",
                                                  "step 3"]
    for ln in lines:
        fields = dict(kv.split("=") for kv in ln.split(": ", 1)[1].split())
        assert {"loss", "grad_norm", "loss_txt", "loss_img"} <= set(fields)
        assert all(np.isfinite(float(v)) for v in fields.values())
    assert "trainable (fp32 masters)" in text
    assert res["checkpoint"] == out / "checkpoints" / "step_3.pt"
    assert res["checkpoint"].exists() and res["checkpoint_bytes"] > 0
    assert (out / "config.yaml").exists()
    state = torch.load(res["checkpoint"], weights_only=False)
    assert state["step"] == 3


class Killed(Exception):
    pass


def test_resume_takes_the_next_batch_and_the_same_step(tmp_path,
                                                       monkeypatch):
    """A run killed in step 3 resumes from its step-2 checkpoint: step 3
    takes the batch the uninterrupted run took, and gives its loss,
    gradient norm, masters and moments bit for bit."""
    cfg = write_config(tmp_path, training={"save_steps": 2, "max_steps": 3})
    seen, kill_at = [], [None]
    step = Trainer.train_step

    def recorded(self, batch, draws=None):
        if self.step == kill_at[0]:
            raise Killed
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(self, batch, draws)

    monkeypatch.setattr(Trainer, "train_step", recorded)
    run = ["--config", cfg, "--device", "cpu", "--output_dir"]
    a = train.main(run + [str(tmp_path / "a")])
    batches_a, seen[:] = list(seen), []
    kill_at[0] = 2
    with pytest.raises(Killed):
        train.main(run + [str(tmp_path / "b")])
    ckpts = sorted(p.name for p in (tmp_path / "b" / "checkpoints").iterdir())
    assert ckpts == ["step_2.pt"]
    kill_at[0], seen[:] = None, []
    b = train.main(run + [str(tmp_path / "b")])
    assert [s for s, _ in b["logged"]] == [3]
    assert len(seen) == 1
    for k, v in batches_a[2].items():
        assert torch.equal(seen[0][k], v), k
    m_a, m_b = a["logged"][-1][1], b["logged"][-1][1]
    for k in ("loss", "grad_norm", "loss_txt", "loss_img"):
        assert m_a[k] == m_b[k], k
    sa = torch.load(a["checkpoint"], weights_only=False)
    sb = torch.load(b["checkpoint"], weights_only=False)
    assert sa["data_state"] == sb["data_state"] == {"epoch": 0, "offset": 3}
    for n, x in sa["params"].items():
        assert torch.equal(x, sb["params"][n]), n
    for mom in ("m", "v"):
        for n, x in sa["opt_state"][mom].items():
            assert torch.equal(x, sb["opt_state"][mom][n]), n


def test_train_step_runs_with_deterministic_cudnn(pipeline_step):
    """The step's forward and backward, and `Trainer.forward_backward`
    alone (what `bench_train` times as fwd+bwd), run with cuDNN's
    deterministic algorithms (on the card the default weight-gradient
    algorithms of the tiny preset's fp32 UNet convolutions vary between
    runs, and a resume would then not repeat the uninterrupted step); the
    setting is restored after them, also when the step raises."""
    s = pipeline_step
    model = build_model(s["pcfg"], "cpu", torch.float32,
                        optim=topt.OptimConfig(**OPTIM))
    tr = Trainer(model, TrainerConfig(optim=topt.OptimConfig(**OPTIM)),
                 "cpu")
    seen = []
    forward = type(model).forward

    def spy(self, *a, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        if len(seen) == 3:
            raise Killed
        return forward(self, *a, **kw)

    before = torch.backends.cudnn.deterministic
    batch = to_device(s["t_first"], "cpu")
    try:
        type(model).forward = spy
        tr.train_step(batch, [s["draws"]])
        assert torch.backends.cudnn.deterministic == before
        tr.forward_backward(batch, [s["draws"]])
        assert torch.backends.cudnn.deterministic == before
        with pytest.raises(Killed):
            tr.train_step(batch, [s["draws"]])
    finally:
        type(model).forward = forward
    assert seen == [True, True, True]
    assert before is False and torch.backends.cudnn.deterministic is False


@pytest.mark.parametrize("case", ["mesh", "distributed", "load_from",
                                  "no_cuda"])
def test_train_main_refuses_what_the_port_lacks(case, tmp_path, monkeypatch):
    """A multi-device mesh and ``distributed.initialize`` outside torchrun
    raise: there is no process group to train on; a ``--load_from`` that is
    not a checkpoint is refused; without CUDA and without ``--device cpu``
    nothing runs on the CPU."""
    sections = {"mesh": {"mesh": {"fsdp": 2}},
                "distributed": {"distributed": {"initialize": True}}}
    argv = ["--config", write_config(tmp_path, **sections.get(case, {})),
            "--output_dir", str(tmp_path / "out")]
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    err, match = RuntimeError, "no process group"
    if case == "load_from":
        (tmp_path / "ckpt").write_text("not a checkpoint")
        argv += ["--load_from", str(tmp_path / "ckpt"), "--device", "cpu"]
        err, match = ValueError, "not a checkpoint"
    elif case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        err, match = RuntimeError, "--device cpu"
    else:
        argv += ["--device", "cpu"]
    with pytest.raises(err, match=match):
        train.main(argv)
    assert not (tmp_path / "out" / "checkpoints").exists()


# --------------------------------------------------------------------------
# the benchmarks


def test_make_batch_is_the_bench_recipe():
    """`bench.py:84-108` (and the B=8 images after them), for
    ``RandomState(0)`` at the base preset, in numpy."""
    cfg = j_base(seq_len=512, max_num_images=2, remat=False)
    rng = np.random.RandomState(0)
    S, ntok, L, B = cfg.special, cfg.num_img_token, 128, 2
    row = [S.bos_token_id, 5, S.soi_token_id] + [S.image_token_id] * ntok
    row += list(rng.randint(10, 30000, size=L - len(row)))
    ids = np.tile(np.asarray(row[:L], np.int32), (B, 1))
    enc = cfg.visual.encoder.vit.image_size
    dec = cfg.image_decoder.image_size
    images = rng.rand(B, 2, enc, enc, 3).astype(np.float32)
    images_dec = rng.rand(B, 2, dec, dec, 3).astype(np.float32)
    images8 = rng.rand(8, 2, enc, enc, 3).astype(np.float32)

    pcfg = bench.PRESETS["base"]()
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    prng = np.random.RandomState(0)
    got = bench.make_batch(pcfg, B, prng)
    got8 = bench.make_batch(pcfg, 8, prng, row=got["text_ids"][0])
    want = dict(text_ids=ids, image_tensors=images,
                num_image_per_seq=np.ones((B,), np.int32),
                attention_mask=np.ones_like(ids),
                image_tensors_dec=images_dec)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert sorted(got8) == sorted(set(want) - {"image_tensors_dec"})
    assert np.array_equal(got8["text_ids"], np.tile(ids[:1], (8, 1)))
    assert np.array_equal(got8["image_tensors"], images8)


def test_text_half_gives_jax_greedy_tokens():
    """The tiny preset (no image decoder, 2 image slots) on JAX's noised
    params: `bench.text_half` on `bench.make_batch`'s prompt gives the
    tokens of JAX's `generate_texts` with the bench's config."""
    n = 8
    jcfg = j_tiny(with_image_decoder=False, max_num_images=2)
    pcfg = tcfg.tiny_config(with_image_decoder=False, max_num_images=2)
    batch = bench.make_batch(pcfg, 2, np.random.RandomState(0))
    jmodel = MMInterleaved(jcfg)
    params = noised_init(jmodel, {k: batch[k] for k in (
        "text_ids", "image_tensors", "num_image_per_seq")})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(j_generate_texts(
        jmodel, params, jb["text_ids"], jb["image_tensors"],
        jb["num_image_per_seq"], jb["attention_mask"],
        JGenCfg(max_new_tokens=n, eos_token_ids=bench.NEVER_EOS,
                pad_token_id=jcfg.special.pad_token_id)))
    model = build_model(pcfg, "cpu", torch.float32)
    load_flax_params(model, params["params"])
    got = bench.text_half(model, to_device(batch, "cpu"), n)
    assert got.shape == (2, n)
    np.testing.assert_array_equal(got.numpy(), want)


# the keys of the JAX benchmarks' lines (bench.py:236-258,
# bench_train.py:98-106,190-200,211-221), less the int8 decode fields and
# the modelled optimizer update, which the port does not print
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline_est_turns_per_sec",
    "decode_ms_per_tok_latency", "denoise_steps_per_sec", "throughput_batch",
    "decode_ms_per_tok_throughput", "tokens_per_sec_throughput",
    "decode_hbm_util_est", "decode_mfu_est",
}
BENCH_TRAIN_KEYS = {
    "metric", "unit", "value", "vs_baseline",
    "small_steps_per_sec", "small_tokens_per_sec", "small_step_ms",
    "small_batch", "small_seq_len", "small_n_params", "small_train_mfu_est",
    "base_fwdbwd_steps_per_sec", "base_fwdbwd_tokens_per_sec",
    "base_fwdbwd_step_ms", "base_batch", "base_seq_len", "base_n_params",
    "base_fwdbwd_mfu_est",
}
TINY_ENV = {
    bench: dict(BENCH_PRESET="tiny", BENCH_BATCH="2", BENCH_DECODE_TOKENS="3",
                BENCH_DENOISE_STEPS="2", BENCH_REPS="1",
                BENCH_THROUGHPUT_BATCH="2"),
    bench_train: dict(BENCH_TRAIN_REPS="1", BENCH_TRAIN_BATCH="2"),
}


def tiny_bench(mod, monkeypatch):
    """``mod`` at the tiny preset and small counts: the environment of
    `TINY_ENV`; for `bench_train`, both sections' configs replaced by the
    tiny preset with 2 image slots."""
    for k, v in TINY_ENV[mod].items():
        monkeypatch.setenv(k, v)
    if mod is bench_train:
        def tiny(**_):
            return tcfg.tiny_config(max_num_images=2)

        monkeypatch.setattr(bench_train, "small_config", tiny)
        monkeypatch.setattr(bench_train, "base_config", tiny)


@pytest.mark.parametrize("mod", [bench, bench_train],
                         ids=["bench", "bench_train"])
def test_bench_prints_one_json_line(mod, monkeypatch, capsys):
    tiny_bench(mod, monkeypatch)
    assert mod.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    keys = BENCH_KEYS if mod is bench else BENCH_TRAIN_KEYS
    assert keys <= set(out), keys - set(out)
    assert out["device"] == "cpu"
    for k, v in out.items():
        if isinstance(v, (int, float)):
            assert np.isfinite(v) and v > 0, (k, v)
    if mod is bench_train:
        assert out["base_full_step_ms"] > 0


@pytest.mark.parametrize("mod", [bench, bench_train],
                         ids=["bench", "bench_train"])
def test_bench_failure_propagates(mod, monkeypatch, capsys):
    """A step that raises inside a section ends the run with the error and
    no line (the JAX benchmarks print ``value: 0`` and exit 0)."""
    tiny_bench(mod, monkeypatch)

    def boom(*a, **kw):
        raise RuntimeError("boom")

    if mod is bench:
        monkeypatch.setattr(bench, "image_half", boom)
    else:
        monkeypatch.setattr(Trainer, "train_step", boom)
    with pytest.raises(RuntimeError, match="boom"):
        mod.main(["--device", "cpu"])
    assert capsys.readouterr().out.strip() == ""
