"""The image routes of the evaluation slice of the PyTorch port against
the JAX package's, on the tiny preset with its image decoder (every param
leaf noised, the VAE decoding in fp32 on both sides), on the synthetic
files of `data.synthetic_eval`.

The port cannot draw JAX's random numbers, so the JAX runtime records the
latents and per-step noise of each denoise call (its key sequence) and the
port's runtime is fed them in the same order.  Then, for t2i and
storytelling: every generated image within atol 1e-4, FID through
`CLIPViTFeatures` (and storytelling's CLIP image-image similarity) within
1e-4 relative.  `CLIPViTFeatures` alone within 1e-4.
"""

import numpy as np
import pytest

from mm_interleaved_tpu.engine.evaluator import (
    EvalConfig as JEvalConfig,
    Evaluator as JEvaluator,
)
from mm_interleaved_tpu.utils.fid import CLIPViTFeatures as JFeatures
from mm_interleaved_tpu_torch import evaluate
from mm_interleaved_tpu_torch.data.synthetic_eval import write_eval_assets
from mm_interleaved_tpu_torch.engine.evaluator import EvalConfig, Evaluator
from mm_interleaved_tpu_torch.utils.fid import CLIPViTFeatures

from _torch_eval_parity import (InjectedPort, RecordingJax, jax_entry,
                                tiny_pair, tokenizers)

STEPS = 2
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, params, model = tiny_pair(with_image_decoder=True)
    jtok, ptok = tokenizers(jcfg, model.cfg)
    return jcfg, jmodel, params, model, jtok, ptok


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return write_eval_assets(str(tmp_path_factory.mktemp("eval")))


def _features(pair):
    jcfg, _, params, model = pair[:4]
    enc = params["params"]["visual_tokenizer"]["encoder"]
    return (JFeatures(jcfg.visual.encoder.vit, {"params": enc}),
            CLIPViTFeatures(model.visual_tokenizer.encoder))


def test_clip_vit_features_match_jax(pair):
    """The cls features of images at another size (resized bicubic), in
    batches of 32 and a tail."""
    jf, pf = _features(pair)
    images = np.random.RandomState(0).rand(3, 16, 16, 3).astype(np.float32)
    want, got = jf(images), pf(images)
    assert got.shape == want.shape == (3, pair[0].visual.encoder.vit
                                       .hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,route", [
    ("synthetic_t2i", "evaluate_t2i"),
    ("synthetic_story", "evaluate_storytelling")])
def test_image_routes_match_jax_with_injected_draws(pair, assets, tmp_path,
                                                    name, route):
    """The same batches through both evaluators (2 DDPM steps, guidance
    3.5): each denoise call's images within atol 1e-4; FID (and the i2i
    similarity) within 1e-4 relative."""
    jcfg, jmodel, params, model, jtok, ptok = pair
    ds_cfg = next(s for s in assets if s["dataset_name"] == name)
    j_evaluate = jax_entry("evaluate")
    ds, coll, mode = j_evaluate.build_eval_dataset(ds_cfg, jcfg, jtok)
    from mm_interleaved_tpu.data.datasets import iterate_dataset

    batches = list(iterate_dataset(ds, 2, coll))
    base = dict(batch_size=2, num_inference_steps=STEPS)
    jrt = RecordingJax(jmodel, params)
    jev = JEvaluator(jmodel, params, jtok, j_evaluate.resolve_eval_config(
        JEvalConfig(output_dir=str(tmp_path / "jax"), **base), mode, ds_cfg,
        set(base)), runtime=jrt)
    jf, pf = _features(pair)
    want = getattr(jev, route)(iter(batches), dataset_name=name,
                               feature_fn=jf)
    prt = InjectedPort(model, jrt.draws)
    pev = Evaluator(model, ptok, evaluate.resolve_eval_config(
        EvalConfig(output_dir=str(tmp_path / "port"), **base), mode, ds_cfg,
        set(base)), runtime=prt)
    got = getattr(pev, route)(iter(batches), dataset_name=name,
                              feature_fn=pf)
    assert len(prt.images) == len(jrt.images) == \
        (1 if route == "evaluate_t2i" else 2)
    assert not prt.draws
    for g, w in zip(prt.images, jrt.images):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    assert got["num_generated"] == want["num_generated"] > 0
    keys = ["fid"] + (["clip_sim_i2i"] if route != "evaluate_t2i" else [])
    for k in keys:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got, want)
