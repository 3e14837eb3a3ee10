"""The port's data layer and config loader against the JAX package's.

`mm_interleaved_tpu_torch.data` and `utils.config` are copies of the JAX
package's numpy/PIL modules (the port imports nothing of it).  On the same
config and seed, both `build_train_iterator`s must give the same batches,
bit for bit: the example batch, the first 6 batches (across an epoch
boundary) and the batch after a `restore`; the image transforms the same
pixels on the native path and on the numpy path; `build_model_config` the
same field values for every preset and every YAML of ``configs/``.
"""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest
from PIL import Image

from mm_interleaved_tpu.configs import tiny_config as j_tiny
from mm_interleaved_tpu.data import native as j_native
from mm_interleaved_tpu.data import transforms as j_transforms
from mm_interleaved_tpu.data.pipeline import (
    build_train_iterator as j_build_train_iterator,
)
from mm_interleaved_tpu.utils import config as j_config
from mm_interleaved_tpu_torch.configs import tiny_config as t_tiny
from mm_interleaved_tpu_torch.data import native as t_native
from mm_interleaved_tpu_torch.data import transforms as t_transforms
from mm_interleaved_tpu_torch.data.pipeline import (
    build_train_iterator as t_build_train_iterator, prefetch,
)
from mm_interleaved_tpu_torch.utils import config as t_config

from _torch_parity import one_native_build  # noqa: F401 (autouse)

# each epoch holds 4 batches, so the first 6 cross into epoch 1
DATA = {
    "interleaved": {"per_device_batch_size": 2, "seed": 0,
                    "datasets": [{"name": "synthetic", "num_samples": 16}]},
    "sft": {"task": "sft", "per_device_batch_size": 2, "seed": 0,
            "datasets": [{"name": "synthetic_sft", "num_samples": 8}]},
}


def assert_batches_equal(got, want):
    """The same keys, dtypes, shapes and values."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("task", sorted(DATA))
def test_train_iterator_matches_jax(task):
    """The example batch, the first 6 batches (epochs 0 and 1) and the
    positions after each equal JAX's; a `restore` at offset 3 of epoch 0,
    and at the position after batch 6, gives the same next batch on both
    sides, the one the uninterrupted stream gave."""
    j_it, j_first = j_build_train_iterator(DATA[task], j_tiny())
    t_it, t_first = t_build_train_iterator(DATA[task], t_tiny())
    assert_batches_equal(t_first, j_first)
    stream, states = [], []
    for _ in range(7):
        b = next(t_it)
        assert_batches_equal(b, next(j_it))
        assert t_it.state() == j_it.state()
        stream.append(b)
        states.append(t_it.state())
    assert states[3:5] == [{"epoch": 0, "offset": 4},
                           {"epoch": 1, "offset": 1}]
    assert_batches_equal(t_first, stream[0])
    for pos, nxt in (({"epoch": 0, "offset": 3}, 3), (states[5], 6)):
        j_it.restore(pos)
        t_it.restore(pos)
        b = next(t_it)
        assert_batches_equal(b, next(j_it))
        assert_batches_equal(b, stream[nxt])


@pytest.mark.parametrize("task", sorted(DATA))
def test_prefetch_keeps_the_position_of_the_batches_taken(task):
    """Through `prefetch` (2 ahead), the batches are JAX's stream in order
    and `state()` after each is the unprefetched iterator's after the same
    batch, though the thread's iterator runs ahead; a `restore` there
    gives the next batch not taken.  (JAX's `prefetch` has no `state`.)"""
    j_it, _ = j_build_train_iterator(DATA[task], j_tiny())
    t_it, _ = t_build_train_iterator(DATA[task], t_tiny())
    batches = prefetch(t_it, size=2)
    try:
        assert batches.state() == {"epoch": 0, "offset": 0}
        for _ in range(5):
            assert_batches_equal(next(batches), next(j_it))
            assert batches.state() == j_it.state()
        # the thread runs ahead of the batches taken
        deadline = time.monotonic() + 30
        while t_it.state() == j_it.state() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t_it.state() != j_it.state()
        pos = batches.state()
    finally:
        batches.close()
    t_it.restore(pos)
    assert_batches_equal(next(t_it), next(j_it))


def test_prefetch_raises_the_pipeline_error_and_ends():
    """An error of the data path is raised by the `next` that would have
    taken its batch, after the batches before it; an iterator without
    `state` gives the position None; the end stays the end."""
    def failing():
        yield {"x": np.zeros(1)}
        raise ValueError("bad shard")

    batches = prefetch(failing())
    assert batches.state() is None
    next(batches)
    with pytest.raises(RuntimeError, match="data pipeline failed") as e:
        next(batches)
    assert isinstance(e.value.__cause__, ValueError)
    batches.close()
    done = prefetch(iter([{"x": np.zeros(1)}]))
    assert len(list(done)) == 1
    with pytest.raises(StopIteration):
        next(done)
    done.close()


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_transforms_match_jax(path, monkeypatch):
    """`ImageTransform` and `DualImageTransform` (random crop and flip from
    one seeded RandomState) and `to_array` give JAX's pixels, on the native
    C++ path where it builds and on the numpy/PIL path."""
    if path == "numpy":
        for mod in (j_native, t_native):
            monkeypatch.setattr(mod, "_build_and_load", lambda: None)
    else:
        assert t_native.is_available() == j_native.is_available()
    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 256, (70, 90, 3), np.uint8))
    for make in (
        lambda m: m.ImageTransform(32, random_flip=True, random_crop=True),
        lambda m: m.ImageTransform(24, center_crop=False),
        lambda m: m.DualImageTransform(16, 40, random_flip=True,
                                       random_crop=True),
    ):
        for seed in range(3):
            got = make(t_transforms)(img, np.random.RandomState(seed))
            want = make(j_transforms)(img, np.random.RandomState(seed))
            if not isinstance(want, tuple):
                got, want = (got,), (want,)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.array_equal(t_transforms.to_array(img),
                          j_transforms.to_array(img))


@pytest.mark.parametrize("preset", ["tiny", "small", "base", "flagship"])
def test_build_model_config_matches_jax(preset):
    """Every preset, with an override of a nested and a top-level field:
    the same field values as JAX's (``seq_len`` leaves the LLM's
    ``max_position_embeddings`` at the preset's, as in JAX)."""
    model = {"preset": preset, "overrides": {"seq_len": 256,
                                             "llm": {"mmfs_points": 4}}}
    got = dataclasses.asdict(t_config.build_model_config(model))
    want = dataclasses.asdict(j_config.build_model_config(model))
    assert got == want
    assert got["seq_len"] == 256 and got["llm"]["mmfs_points"] == 4
    if preset == "flagship":
        assert got["llm"]["max_position_embeddings"] == 2048


def test_every_yaml_model_section_loads():
    """Every ``configs/*.yaml`` with a ``model:`` section builds the same
    config as JAX's loader; the dump round-trips."""
    paths = sorted(glob.glob(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "*.yaml")))
    n = 0
    for path in paths:
        cfg = t_config.load_config(path)
        assert cfg == j_config.load_config(path)
        if "model" not in cfg:
            continue
        n += 1
        assert dataclasses.asdict(t_config.build_model_config(
            cfg["model"])) == dataclasses.asdict(
            j_config.build_model_config(cfg["model"])), path
    assert n >= 5


def test_unknown_field_raises_the_jax_message(tmp_path):
    model = {"preset": "tiny", "overrides": {"llm": {"hidden_sise": 8}}}
    with pytest.raises(AssertionError) as j_err:
        j_config.build_model_config(model)
    with pytest.raises(AssertionError) as t_err:
        t_config.build_model_config(model)
    assert str(t_err.value) == str(j_err.value) == \
        "unknown config field LlamaConfig.hidden_sise"
    cfg = {"model": {"preset": "tiny"}, "training": {"seed": 3}}
    t_config.dump_config(cfg, str(tmp_path))
    assert t_config.load_config(str(tmp_path / "config.yaml")) == cfg


def test_test_tokenizer_takes_the_model_special_ids():
    """Without a tokenizer path, at a preset whose special ids differ from
    the test tokenizer's defaults (small: vocabulary 32002, ``<soi>``
    32000), every image of the port's batches is a ``<soi>`` and
    ``num_img_token`` ``<image>`` ids of the model's; JAX's batches hold
    none of the model's (its test tokenizer puts ``<soi>`` at 31995), so
    no image of theirs reaches the model."""
    from mm_interleaved_tpu.configs import small_config as j_small
    from mm_interleaved_tpu_torch.configs import small_config as t_small

    data = {"per_device_batch_size": 2, "seed": 0,
            "datasets": [{"name": "synthetic", "num_samples": 8}]}
    cfg = t_small(max_num_images=2, seq_len=256)
    S = cfg.special
    _, b = t_build_train_iterator(data, cfg)
    n_soi = int((b["text_ids"] == S.soi_token_id).sum())
    assert n_soi == int(b["num_image_per_seq"].sum()) > 0
    assert int((b["text_ids"] == S.image_token_id).sum()) == \
        n_soi * cfg.num_img_token
    _, jb = j_build_train_iterator(data, j_small(max_num_images=2,
                                                 seq_len=256))
    assert not np.isin(jb["text_ids"], [S.soi_token_id,
                                        S.image_token_id]).any()
    assert int((jb["text_ids"] == 31995).sum()) == n_soi


def test_native_pixels_do_not_depend_on_the_build_host(tmp_path):
    """The image kernels built with the port's flags
    (`data.native.FLAGS`: IEEE arithmetic, no FMA contraction) for the
    baseline x86-64 and for x86-64-v3 (AVX2 and FMA) give the same pixels,
    and so does the port's own library: every host computes the same image
    tensors.  With ``-march=native`` (the JAX package's build) the FMAs of
    an AVX2 host round the resampler differently: the first text turn's
    tied greedy token then followed the machine that built the library
    (ROADMAP.md §3)."""
    import ctypes
    import subprocess

    with open("/proc/cpuinfo") as f:
        flags = f.read()
    if " fma" not in flags or " avx2" not in flags:
        pytest.skip("the host runs no x86-64-v3 code")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "mmi_native.cpp")
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (120, 160, 3)).astype(np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)

    def pixels(extra):
        so = str(tmp_path / f"lib{extra[0][7:]}.so")
        subprocess.run(["g++", *t_native.FLAGS, *extra, src, "-o", so],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(so).crop_resize_to_f32
        fn.argtypes = [u8p] + [ctypes.c_int] * 7 + [f32p, ctypes.c_int,
                                                   ctypes.c_int]
        out = np.empty((56, 56, 3), np.float32)
        fn(img.ctypes.data_as(u8p), 120, 160, 3, 5, 7, 110, 150,
           out.ctypes.data_as(f32p), 56, 56)
        return out

    base = pixels(["-march=x86-64"])
    assert np.array_equal(base, pixels(["-march=x86-64-v3", "-mtune=native"]))
    assert np.array_equal(base, t_native.crop_resize_to_f32(
        img, 5, 7, 110, 150, 56, 56))
