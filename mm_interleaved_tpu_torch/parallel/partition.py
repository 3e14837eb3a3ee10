"""The (data, fsdp, tensor) device mesh and the placement plan (counterpart
of `mm_interleaved_tpu/parallel/partition.py`).

One rank is one device.  `make_mesh` lays the `torch.distributed` world out
as a `DeviceMesh` named ``("data", "fsdp", "tensor")``, rank ``(d * fsdp +
f) * tensor + t`` at ``(d, f, t)``.

The plan, `DEFAULT_RULES`, is the JAX package's regex rules on the port's
parameter names, in the port's layout (a Linear weight is ``[out, in]``,
the transpose of a flax kernel; an embedding is ``[rows, width]`` in both),
first match wins, fitted by `fit_spec` as JAX's `_fit_spec` fits a spec:
right-aligned to the trailing dims, an axis dropped where it does not
divide its dim.  `placement_for` reads a parameter's fitted spec as the dim
it is cut along over ``tensor`` and the dim FSDP2 shards over ``fsdp``.

Eager PyTorch has no GSPMD to keep a cut layer's function whole, so the
plan differs from the JAX rules over ``tensor`` (ROADMAP.md §3):

  * only the LLM's Megatron pairs are cut over ``tensor``
    (`parallel.tensor`): attention by head (``q/k/v_proj`` columns,
    ``o_proj`` rows), the MLP by hidden column (``gate/up_proj``,
    ``down_proj``), and the LLM's MMFS by head: ``value_proj`` (its bias
    too), the head-major rows of ``sampling_offsets`` and
    ``attention_weights`` (weight and bias), ``ignore_token``, and
    ``output_proj`` by row; an int8 column layer's scales follow its rows;
  * kept whole over ``tensor`` where JAX cuts them (still sharded over
    ``fsdp``): ``dynamic_offset_mask`` (its output feeds
    ``sampling_offsets`` whole), ``embed_tokens``, the text heads, and the
    towers (the ViT and its adapter, the Q-Formers, the UNet with MMFSNet,
    the VAE): the UNet's ``ff_in`` is ``[value | gate]``, which a column cut
    would hand out as halves.

`shard_fsdp` applies the fsdp half with FSDP2 (`fully_shard`) on the mesh's
``fsdp`` dim: each unit of `FSDP_UNITS` (a module that reads its sharded
weights inside its own forward, or in a method of `FSDP_METHODS`,
registered) shards the parameters the plan shards along the plan's dim and
keeps the rest whole (``ignored_params``).  A weight the plan shards that no
unit holds raises.  `batch_rows` is a rank's rows of a global batch: the
batch is split over ``(data, fsdp)`` as JAX's `batch_sharding` splits it,
and runs replicated where that does not divide it.
"""

from __future__ import annotations

import math
import re
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

from torch import nn

AXES = ("data", "fsdp", "tensor")

# ``[out, in]`` cut over tensor by output (heads, hidden columns) with fsdp
# on the input: JAX's P("fsdp", "tensor") on ``[in, out]``
COLUMN = ("tensor", "fsdp")
# cut over tensor by input: JAX's P("tensor", "fsdp")
ROW = ("fsdp", "tensor")

_LLM = r"^mm_decoder\.layers\.\d+\."
_MMFS = _LLM + r"llama_cross_attn\.attn\."

DEFAULT_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- the LLM's tensor-parallel pairs
    (_LLM + r"(self_attn\.[qkv]_proj|mlp\.(gate|up)_proj)\.weight$", COLUMN),
    (_LLM + r"(self_attn\.[qkv]_proj|mlp\.(gate|up)_proj)\.scale$",
     ("tensor",)),
    (_LLM + r"(self_attn\.o_proj|mlp\.down_proj)\.weight$", ROW),
    # --- the LLM's MMFS, by head
    (_MMFS + r"value_proj\.weight$", COLUMN),
    (_MMFS + r"(value_proj\.bias|ignore_token)$", ("tensor",)),
    (_MMFS + r"(sampling_offsets|attention_weights)\.(weight|bias)$",
     ("tensor", None)),
    (_MMFS + r"output_proj\.weight$", ROW),
    # --- JAX's other rules, whole over tensor
    (r"(^|\.)embed_tokens\.weight$", (None, "fsdp")),
    (r"^text_decoder\.(head|head_new)\.weight$", (None, "fsdp")),
    (r"\.(value_proj|dynamic_offset_mask)\.weight$", (None, "fsdp")),
    (r"\.output_proj\.weight$", ("fsdp", None)),
    (r"\.query_relpos\.weight$", (None, "fsdp")),
    (r"\.(fc1|intermediate|ff_in)\.weight$", (None, "fsdp")),
    (r"\.(fc2|ffn_output|ff_out)\.weight$", ("fsdp", None)),
    (r"\.(q_proj|k_proj|v_proj|gate_proj|up_proj|query|key|value|to_q|to_k|"
     r"to_v|attn[12]_[qkv])\.weight$", (None, "fsdp")),
    (r"\.(o_proj|down_proj|output|to_out|attn[12]_out|out_proj)\.weight$",
     ("fsdp", None)),
    # --- everything else (convs, norms, biases, embeddings of positions)
    (r".*", ()),
)

# FSDP2's units: each reads the weights the plan shards only inside its own
# forward or a method of FSDP_METHODS (the MMFSNet blocks' image side,
# prepared once before the denoise loop).  No unit holds another, so each
# is its own root and reshards after each call.
FSDP_UNITS = (
    r"visual_tokenizer\.encoder\.(layers|injectors|extractors|"
    r"extra_extractors)\.\d+",
    r"visual_tokenizer\.encoder\.adapter_spm",
    r"(visual_tokenizer|image_decoder)\.perceiver_resampler\.layers\.\d+",
    r"mm_decoder\.embed_tokens",
    r"mm_decoder\.layers\.\d+",
    r"text_decoder",
    r"image_decoder\.unet\.(down_\d+_attn_\d+|mid_attn|up_\d+_attn_\d+)",
    r"image_decoder\.unet\.mmfs_net\.(down_blocks_\d+|mid_block)",
    r"image_decoder\.vae\.(encoder|decoder)\.mid_attn",
)
FSDP_METHODS = ("prepare",)


class Placement(NamedTuple):
    """The dims a parameter is cut along over ``tensor`` and sharded along
    over ``fsdp`` (None: whole)."""

    tensor: Optional[int]
    fsdp: Optional[int]


def axis_sizes(mesh) -> dict:
    """``{"data": d, "fsdp": f, "tensor": t}`` of a `DeviceMesh` or of a
    mapping of axis sizes."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_shape(data: int = -1, fsdp: int = 1, tensor: int = 1,
               world: int = 1) -> Tuple[int, int, int]:
    """The ``(data, fsdp, tensor)`` sizes of a world of ``world`` ranks;
    ``data=-1`` is the rest of it.  A product that is not ``world``
    raises."""
    if fsdp < 1 or tensor < 1 or (data < 1 and data != -1):
        raise ValueError(f"mesh data={data} fsdp={fsdp} tensor={tensor}: "
                         "sizes must be positive (data may be -1)")
    if data == -1:
        if world % (fsdp * tensor):
            raise ValueError(f"fsdp {fsdp} x tensor {tensor} does not divide "
                             f"the world size {world}")
        data = world // (fsdp * tensor)
    if data * fsdp * tensor != world:
        raise ValueError(f"mesh data={data} fsdp={fsdp} tensor={tensor} has "
                         f"{data * fsdp * tensor} ranks; the world has "
                         f"{world}")
    return data, fsdp, tensor


def make_mesh(data: int = -1, fsdp: int = 1, tensor: int = 1,
              device_type: str = "cuda"):
    """A `DeviceMesh` over the initialised `torch.distributed` world, named
    ``("data", "fsdp", "tensor")``; ``data=-1`` is the rest of the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(run under torchrun)")
    shape = mesh_shape(data, fsdp, tensor, dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> Tuple:
    """``spec`` right-aligned to the trailing dims of ``shape`` (a leading
    stack axis stays whole), each axis (or tuple of axes) dropped where its
    size does not divide the dim: JAX's `_fit_spec`."""
    sizes = axis_sizes(mesh)
    lead = max(0, len(shape) - len(spec))
    out = [None] * lead
    for i, dim in enumerate(shape[lead:]):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(None)
            continue
        n = math.prod(sizes[a] for a in (ax if isinstance(ax, tuple)
                                         else (ax,)))
        out.append(ax if dim % n == 0 else None)
    return tuple(out)


def spec_for(name: str, shape: Sequence[int], mesh,
             rules=DEFAULT_RULES) -> Tuple:
    """The fitted spec of the first rule that matches ``name``.  A
    convolution's ``[out, in, kh, kw]`` takes a Linear's ``[out, in]``
    spec on its leading dims (a flax kernel is ``[kh, kw, in, out]``)."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            if len(shape) == 4 and len(spec) == 2:
                spec = tuple(spec) + (None, None)
            return fit_spec(spec, shape, mesh)
    return fit_spec((), shape, mesh)


def placement_for(name: str, shape: Sequence[int], mesh,
                  rules=DEFAULT_RULES) -> Placement:
    """``name``'s tensor and fsdp dims on ``mesh`` (a `DeviceMesh` or a
    mapping of axis sizes): where its fitted spec puts each axis."""
    spec = spec_for(name, shape, mesh, rules)
    sizes = axis_sizes(mesh)

    def dim_of(axis):
        if sizes[axis] == 1 or axis not in spec:
            return None
        return spec.index(axis)

    return Placement(dim_of("tensor"), dim_of("fsdp"))


def rank_bytes(model: nn.Module, mesh, pattern: str = "") -> int:
    """The bytes of the parameters whose names ``pattern`` matches
    (`re.search`) that one rank holds under the plan on ``mesh`` (a
    `DeviceMesh` or a mapping of axis sizes: the model may be whole, on
    ``meta``)."""
    sizes = axis_sizes(mesh)
    total = 0
    for name, p in model.named_parameters():
        if not re.search(pattern, name):
            continue
        pl = placement_for(name, p.shape, sizes)
        n = p.numel()
        for axis, dim in (("tensor", pl.tensor), ("fsdp", pl.fsdp)):
            if dim is not None:
                n //= sizes[axis]
        total += n * p.element_size()
    return total


def shard_fsdp(model: nn.Module, mesh, rules=DEFAULT_RULES) -> int:
    """FSDP2 over the mesh's ``fsdp`` dim on each module of `FSDP_UNITS`:
    the parameters the plan shards along their plan dim, the others kept
    whole; each unit's `FSDP_METHODS` registered.  Returns the units made
    (0 where ``fsdp`` is 1).  A parameter the plan shards outside every
    unit raises."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    if axis_sizes(mesh)["fsdp"] == 1:
        return 0
    units = [(n, m) for n, m in model.named_modules()
             if any(re.fullmatch(p, n) for p in FSDP_UNITS)]
    dims = {}
    for name, p in model.named_parameters():
        dim = placement_for(name, p.shape, mesh, rules).fsdp
        if dim is not None:
            dims[name] = dim
    held = set()
    made = 0
    for uname, unit in units:
        shard = {}
        ignored = set()
        for leaf, p in unit.named_parameters():
            name = f"{uname}.{leaf}"
            if name in dims:
                shard[p] = dims[name]
                held.add(name)
            else:
                ignored.add(p)
        if not shard:
            continue
        fully_shard(unit, mesh=mesh["fsdp"], reshard_after_forward=True,
                    shard_placement_fn=lambda p, s=shard: Shard(s[p]),
                    ignored_params=ignored)
        for method in FSDP_METHODS:
            if hasattr(unit, method):
                register_fsdp_forward_method(unit, method)
        made += 1
    loose = sorted(set(dims) - held)
    if loose:
        raise ValueError(f"{len(loose)} parameters the plan shards over fsdp "
                         f"lie in no FSDP unit: {loose[:4]}")
    return made


def batch_rows(mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows: the batch split
    over ``(data, fsdp)``, rank ``(d, f)`` taking block ``d * fsdp + f``;
    all of it where ``data * fsdp`` does not divide it (replicated, JAX's
    drop rule)."""
    sizes = axis_sizes(mesh)
    n = sizes["data"] * sizes["fsdp"]
    if n == 1 or batch % n:
        return slice(0, batch)
    block = (mesh.get_local_rank("data") * sizes["fsdp"]
             + mesh.get_local_rank("fsdp"))
    per = batch // n
    return slice(block * per, (block + 1) * per)
