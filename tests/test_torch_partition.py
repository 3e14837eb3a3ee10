"""The port's mesh and placement plan (`parallel.partition`) against the
JAX package's (`mm_interleaved_tpu/parallel/partition.py`), in one
process.

  * `mesh_shape`, `make_mesh`'s arithmetic, ``data=-1`` included;
  * `fit_spec` equal to JAX's `_fit_spec` over a table of shapes, specs
    and meshes (JAX on the conftest's 8 virtual CPU devices);
  * every parameter of the tiny preset and of the flagship (built on
    ``meta``), bf16 and int8: the port's tensor and fsdp dims equal those
    of JAX's `spec_for_path` on the flax path `utils.from_flax.
    param_jax_paths` maps it to, transposed to the port's layout, except
    the deviations `DEVIATIONS` names; every weight the plan shards over
    fsdp lies in an FSDP unit;
  * per-rank bytes at the flagship under ``fsdp 4 x tensor 2``: the LLM's
    projections at 1/8 within 1%, bf16 and int8 (codes and scales).
"""

import re

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

from mm_interleaved_tpu.parallel.partition import _fit_spec, spec_for_path
from mm_interleaved_tpu.parallel.partition import make_mesh as j_make_mesh
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
from mm_interleaved_tpu_torch.ops.quant import QLinear, quantize_llm_weights
from mm_interleaved_tpu_torch.parallel.partition import (
    FSDP_UNITS, fit_spec, mesh_shape, placement_for, rank_bytes)
from mm_interleaved_tpu_torch.utils.from_flax import param_jax_paths

SIZES = dict(data=1, fsdp=4, tensor=2)

_LLM = r"^mm_decoder\.layers\.\d+\."
_MMFS = _LLM + r"llama_cross_attn\.attn\."
_PROJ = _LLM + r"(self_attn\.[qkvo]_proj|mlp\.(gate|up|down)_proj)\."

# Where the port's plan departs from the JAX rules, and why: (pattern,
# reason, the port's dims from JAX's: "no tensor" keeps JAX's fsdp dim and
# drops its tensor dim; a dict gives the port's dims outright)
DEVIATIONS = (
    (r"(^|\.)embed_tokens\.weight$", "the vocab-parallel embedding is "
     "ROADMAP item 6c", "no tensor"),
    (r"^text_decoder\.", "the vocab-parallel text heads are item 6c",
     "no tensor"),
    (r"\.dynamic_offset_mask\.weight$", "its output feeds sampling_offsets "
     "whole: a column shard computes another function", "no tensor"),
    (r"^(visual_tokenizer|image_decoder)\.", "the towers stay whole over "
     "tensor (the UNet's ff_in is [value | gate]); item 6c", "no tensor"),
    (_MMFS + r"(sampling_offsets|attention_weights)\.(weight|bias)$",
     "the LLM's MMFS by head: the head-major rows go with their heads "
     "(GSPMD keeps JAX's whole)", dict(tensor=0, fsdp=None)),
    (_MMFS + r"(value_proj\.bias|ignore_token)$", "by head, with "
     "value_proj's columns", dict(tensor=0, fsdp=None)),
    (_LLM + r"(self_attn\.[qkv]_proj|mlp\.(gate|up)_proj)\.scale$",
     "an int8 column layer's scales follow its rows (JAX's qscale is "
     "whole)", dict(tensor=0, fsdp=None)),
)


def test_mesh_shape_arithmetic():
    assert mesh_shape(-1, 4, 2, world=8) == (1, 4, 2)
    assert mesh_shape(-1, 1, 1, world=4) == (4, 1, 1)
    assert mesh_shape(-1, 2, 1, world=8) == (4, 2, 1)
    assert mesh_shape(2, 2, 2, world=8) == (2, 2, 2)
    assert mesh_shape(1, 1, 1, world=1) == (1, 1, 1)
    for args, world in (((-1, 3, 1), 8), ((2, 2, 1), 8), ((1, 1, 2), 1),
                        ((0, 1, 1), 1), ((1, 0, 2), 2), ((-2, 1, 1), 2)):
        with pytest.raises(ValueError):
            mesh_shape(*args, world=world)


SPECS = [P("fsdp", "tensor"), P("tensor", "fsdp"), P(None, "fsdp"),
         P(None,), P(), P(("data", "fsdp")), P(("data", "fsdp"), "tensor"),
         P("tensor")]
SHAPES = [(8, 4), (6, 4), (4, 6), (3, 5), (2, 8, 4), (12,), (16, 3),
          (1, 1, 1, 8), ()]
MESHES = [(1, 4, 2), (2, 2, 2), (8, 1, 1), (1, 1, 8), (2, 4, 1)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "%d_%d_%d" % m)
def test_fit_spec_equals_jax(mesh):
    jmesh = j_make_mesh(*mesh)
    sizes = dict(zip(("data", "fsdp", "tensor"), mesh))
    for spec in SPECS:
        for shape in SHAPES:
            want = tuple(_fit_spec(spec, shape, jmesh))
            assert fit_spec(tuple(spec), shape, sizes) == want, (spec, shape)


def _port_dims_of_jax(module, leaf, shape, jax_path, jmesh, sizes):
    """JAX's spec for the leaf, as the port's ``{axis: dim}`` (axes of size
    1 dropped, as the port's placement drops them)."""
    linear = isinstance(module, (nn.Linear, QLinear)) and leaf == "weight"
    if linear:
        jshape = tuple(shape)[::-1]
    elif len(shape) == 4:
        jshape = (shape[2], shape[3], shape[1], shape[0])
    else:
        jshape = tuple(shape)
    if isinstance(module, QLinear) and leaf == "weight":
        jax_path = jax_path.rsplit("/", 1)[0] + "/kernel"
    spec = spec_for_path(jax_path, jshape, jmesh)
    # flax [in, out] -> [out, in]; [kh, kw, in, out] -> [out, in, kh, kw]
    to_port = ({0: 1, 1: 0} if linear else {0: 2, 1: 3, 2: 1, 3: 0}
               if len(jshape) == 4 else {j: j for j in range(len(jshape))})
    dims = dict(tensor=None, fsdp=None)
    for j, ax in enumerate(tuple(spec)):
        if ax in dims and sizes[ax] > 1:
            dims[ax] = to_port[j]
    return dims


def _check_plan(model, sizes):
    jmesh = j_make_mesh(sizes["data"], sizes["fsdp"], sizes["tensor"])
    paths = param_jax_paths(model)
    mods = dict(model.named_modules())
    units = [n for n in mods if any(re.fullmatch(p, n) for p in FSDP_UNITS)]
    seen = {reason: 0 for _, reason, _ in DEVIATIONS}
    sharded = 0
    for name, p in model.named_parameters():
        mod_name, _, leaf = name.rpartition(".")
        want = _port_dims_of_jax(mods[mod_name], leaf, p.shape, paths[name],
                                 jmesh, sizes)
        for pattern, reason, how in DEVIATIONS:
            if re.search(pattern, name):
                seen[reason] += 1
                want = (dict(want, tensor=None) if how == "no tensor"
                        else dict(how))
                break
        pl = placement_for(name, p.shape, sizes)
        assert dict(tensor=pl.tensor, fsdp=pl.fsdp) == want, name
        if pl.fsdp is not None:
            sharded += 1
            assert any(name.startswith(u + ".") for u in units), name
    return seen, sharded


def _models():
    with torch.device("meta"):
        return {"tiny": MMInterleaved(tcfg.tiny_config()),
                "flagship": MMInterleaved(tcfg.flagship_config())}


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["tiny", "flagship"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_plan_equals_jax_rules_but_the_named_deviations(models, name, int8):
    model = models[name] if not int8 else _models()[name]
    if int8:
        quantize_llm_weights(model)
    seen, sharded = _check_plan(model, SIZES)
    # every deviation names parameters that exist (the int8 one only in
    # the int8 model)
    for reason, n in seen.items():
        assert n > 0 or (not int8 and "int8" in reason), reason
    assert sharded > 10


def test_flagship_llm_projections_at_one_eighth_per_rank(models):
    """fsdp 4 x tensor 2: each rank holds 1/8 of the LLM's projections, in
    bf16 and in int8 (codes and scales), within 1%; what the plan keeps
    whole over both axes (norms, biases, convs) is the rest."""
    for int8 in (False, True):
        model = _models()["flagship"].to(torch.bfloat16)
        if int8:
            quantize_llm_weights(model)
        whole = rank_bytes(model, dict(data=1, fsdp=1, tensor=1), _PROJ)
        mine = rank_bytes(model, SIZES, _PROJ)
        assert whole > (12e9 if int8 else 25e9)
        assert mine / whole == pytest.approx(1 / 8, rel=0.01), int8
        n_scales = sum(p.numel() for n, p in model.named_parameters()
                       if re.search(_PROJ, n) and n.endswith(".scale"))
        assert (n_scales > 0) == int8


def test_rank_bytes_counts_the_tiny_plan(models):
    """At the tiny preset (widths 4 to 64) every split divides: the LLM's
    projections at 1/8, the towers' sharded weights at 1/4."""
    model = models["tiny"]
    whole = rank_bytes(model, dict(data=1, fsdp=1, tensor=1), _PROJ)
    assert rank_bytes(model, SIZES, _PROJ) * 8 == whole
    ff = r"^image_decoder\.unet\..*\.ff_(in|out)\.weight$"
    assert rank_bytes(model, SIZES, ff) * 4 == rank_bytes(
        model, dict(data=1, fsdp=1, tensor=1), ff)
    assert np.isclose(rank_bytes(model, SIZES, r"norm"),
                      rank_bytes(model, dict(data=1, fsdp=1, tensor=1),
                                 r"norm"))
