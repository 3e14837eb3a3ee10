"""The interleaved inference loop of the PyTorch port against the JAX
package's, on the tiny preset with its image decoder (every param leaf
noised, the VAE decoding in fp32 on both sides): a text -> image -> text
run with ``force_image_every_turn`` on the annt.json of
`data.synthetic_eval`.  The JAX runtime records the draws of its denoise
call and the port's is fed them.  The loaded sample and the texts are
equal, the image within atol 1e-4.
"""

import jax
import numpy as np
import pytest

from mm_interleaved_tpu.inference_loop import (
    InferenceConfig as JInferenceConfig,
    InterleavedInferencePipeline as JPipeline,
)
from mm_interleaved_tpu_torch.data.synthetic_eval import write_inference_assets
from mm_interleaved_tpu_torch.inference_loop import (
    InferenceConfig,
    InterleavedInferencePipeline,
)

from _torch_parity import one_native_build  # noqa: F401 (autouse)
from _torch_eval_parity import (InjectedPort, RecordingJax, tiny_pair,
                                tokenizers)

STEPS = 2
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, params, model = tiny_pair(with_image_decoder=True)
    jtok, ptok = tokenizers(jcfg, model.cfg)
    return jcfg, jmodel, params, model, jtok, ptok


def test_inference_loop_matches_jax_with_injected_draws(pair, tmp_path):
    """text -> image -> text, the image forced: the loaded sample, the two
    texts and the generated image (atol 1e-4) equal JAX's."""
    jcfg, jmodel, params, model, jtok, ptok = pair
    annt = write_inference_assets(str(tmp_path))
    kw = dict(num_iter=3, max_new_tokens=5, num_inference_steps=STEPS,
              force_image_every_turn=True)
    jrt = RecordingJax(jmodel, params)
    jpipe = JPipeline(jmodel, params, jtok, JInferenceConfig(**kw),
                      runtime=jrt)
    jsample = jpipe.load_annt_data(annt, str(tmp_path))[0]
    want = jpipe.run(jsample, rng=jax.random.PRNGKey(3))
    prt = InjectedPort(model, jrt.draws)
    ppipe = InterleavedInferencePipeline(model, ptok, InferenceConfig(**kw),
                                         runtime=prt)
    psample = ppipe.load_annt_data(annt, str(tmp_path))[0]
    np.testing.assert_array_equal(psample["text_ids"], jsample["text_ids"])
    for g, w in zip(psample["images"], jsample["images"]):
        np.testing.assert_array_equal(g, w)
    got = ppipe.run(psample)
    assert len(want["texts"]) == 2 and len(want["images"]) == 1
    assert got["texts"] == want["texts"]
    np.testing.assert_array_equal(got["text_ids"], want["text_ids"])
    assert len(got["images"]) == 1
    np.testing.assert_allclose(got["images"][0], want["images"][0], rtol=0,
                               atol=ATOL)
