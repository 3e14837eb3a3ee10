"""The port's InceptionV3 (`utils/inception_v3.py`) against the JAX
`InceptionV3Features` on the same seeded weights, carried over by each
side's torchvision converter: pool3 features within 1e-4 of their scale,
with 96 px inputs resized to 299 px (both sides' bilinear resize) and
without the resize (the network at 96 px)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mm_interleaved_tpu.utils import inception_v3 as jinc
from mm_interleaved_tpu_torch.utils import inception_v3 as tinc
from mm_interleaved_tpu_torch.utils.name_map import (check_coverage,
                                                     stream_into)


def seeded_state_dict(model, seed=0):
    """torchvision-named tensors of ``model``'s layout, seeded: fan-in
    scaled kernels, batch-norm scales near 1, running variances in [0.5,
    1.5], and the tensors torchvision keeps beside them (the classifier,
    the auxiliary head, the batch counters)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for name, t in tinc.inception_tensors(model):
        shape = tuple(t.shape)
        if name.endswith("conv.weight"):
            x = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("running_var"):
            x = 0.5 + rs.rand(*shape)
        elif name.endswith("bn.weight"):
            x = 1.0 + 0.1 * rs.randn(*shape)
        else:
            x = 0.1 * rs.randn(*shape)
        sd[name] = torch.from_numpy(x.astype(np.float32))
        if name.endswith("running_var"):
            sd[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    return sd


@pytest.fixture(scope="module")
def pair():
    model = tinc.InceptionV3Features()
    sd = seeded_state_dict(model)
    nmap = tinc.convert_torchvision_inception(model)
    targets = dict(tinc.inception_tensors(model))
    check_coverage(nmap, sd.keys(), targets, tinc.INCEPTION_SKIPS)
    stream_into(targets, nmap, sd)
    variables = jinc.convert_torchvision_inception(
        {k: v.numpy() for k, v in sd.items()})
    return model.eval(), variables


@pytest.mark.parametrize("resize", [True, False])
def test_inception_matches_jax(pair, resize):
    model, variables = pair
    x = np.random.RandomState(1).rand(2, 96, 96, 3).astype(np.float32)
    want = np.asarray(jax.jit(jinc.InceptionV3Features(
        resize_input=resize).apply)(variables, jnp.asarray(x)))
    model.resize_input = resize
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_inception_converter_refuses_strays(pair):
    """A key the map does not read (nor skip) and a missing one raise."""
    model, _ = pair
    sd = seeded_state_dict(model)
    nmap = tinc.convert_torchvision_inception(model)
    targets = dict(tinc.inception_tensors(model))
    with pytest.raises(KeyError, match="no entry reads"):
        check_coverage(nmap, list(sd) + ["Mixed_8.conv.weight"], targets,
                       tinc.INCEPTION_SKIPS)
    del sd["Mixed_5b.branch1x1.bn.running_mean"]
    with pytest.raises(KeyError, match="missing"):
        check_coverage(nmap, sd.keys(), targets, tinc.INCEPTION_SKIPS)
