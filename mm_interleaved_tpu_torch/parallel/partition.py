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
it is cut along over ``tensor`` and the dim FSDP2 shards over ``fsdp``;
`plan` places every parameter of a whole model, pairs included.

Eager PyTorch has no GSPMD to keep a cut layer's function whole, so a
cut over ``tensor`` is a Megatron pair (`parallel.tensor`): whole heads or
whole hidden columns on each rank, the column layer's bias with its rows,
the row layer's bias whole (added once, after the sum).  Over ``tensor``
the plan cuts the whole model where JAX's rules do: the LLM's attention,
MLP and MMFS, the ViT (``q/k/v_proj``, ``out_proj``, ``fc1``/``fc2``), the
adapter's deformable attention and ConvFFN, both Q-Formers
(``query/key/value``, ``output``, ``intermediate``/``ffn_output``), the
UNet's transformer blocks (``attn[12]_*``, ``ff_in``/``ff_out``), MMFSNet,
``embed_tokens`` and the text head by vocabulary row.  It departs from
them (ROADMAP.md §3):

  * by head where JAX keeps whole: the deformable attentions' (the
    adapter's, the LLM's and MMFSNet's MMFS) head-major rows of
    ``sampling_offsets`` and ``attention_weights`` (weight and bias) and
    ``ignore_token``; the column layers' biases; an int8 column layer's
    scales; the ConvFFN's depthwise ``dwconv`` by channel, with ``fc1``;
  * ``ff_in`` is ``[value | gate]``: each rank holds the same rows of both
    halves, ``[value_r | gate_r]`` (`tensor_blocks`), not a slice of the
    concatenation;
  * kept whole over ``tensor`` where JAX cuts them (still sharded over
    ``fsdp``): ``dynamic_offset_mask`` (its output feeds
    ``sampling_offsets`` whole), the adapter's SPM 1x1 convs (their outputs
    are the pyramid, read whole), the VAE's one-head attention, and
    ``head_new``;
  * a pair whose heads (or hidden columns) ``tensor`` does not divide is
    kept whole over ``tensor`` (`plan`, from each module's
    ``tensor_pairs``): JAX's drop rule at the unit eager PyTorch can cut,
    where GSPMD cuts mid-head (the flagship UNet's 5-head blocks).

`shard_fsdp` applies the fsdp half with FSDP2 (`fully_shard`) on the mesh's
``fsdp`` dim: each unit of `FSDP_UNITS` (a module that reads its sharded
weights inside its own forward, or in a method of `FSDP_METHODS`,
registered) shards the parameters the plan shards along the plan's dim and
keeps the rest whole (``ignored_params``).  A weight the plan shards that no
unit holds raises.  For training (``train=True``) FSDP2 reduce-scatters
each unit's gradients summed in fp32 (no division: the losses are already
normalised globally) and casts the shard back to the parameter's dtype.
`batch_rows` is a rank's rows of a global batch: the batch is split over
``(data, fsdp)`` as JAX's `batch_sharding` splits it, and runs replicated
where that does not divide it; `row_sum` sums a tensor over the ranks that
hold rows.  `RankLayout` maps a global tensor to a rank's shard of it and
back (the trainer's masters, moments and checkpoints).
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
# the column layers (by output row over tensor) and the row layers (by
# input column) of every Megatron pair outside the LLM's own rules
_COL = (r"(fc1|intermediate|ff_in|q_proj|k_proj|v_proj|query|key|value|"
        r"attn[12]_[qkv]|value_proj)")
_ROW = r"(fc2|ffn_output|ff_out|out_proj|output|attn[12]_out|output_proj)"

DEFAULT_RULES: Tuple[Tuple[str, Tuple], ...] = (
    # --- the LLM's tensor-parallel pairs (an int8 layer's scales follow
    # its rows)
    (_LLM + r"(self_attn\.[qkv]_proj|mlp\.(gate|up)_proj)\.weight$", COLUMN),
    (_LLM + r"(self_attn\.[qkv]_proj|mlp\.(gate|up)_proj)\.scale$",
     ("tensor",)),
    (_LLM + r"(self_attn\.o_proj|mlp\.down_proj)\.weight$", ROW),
    # --- the vocabulary: embedding and text head by row
    (r"(^|\.)embed_tokens\.weight$", COLUMN),
    (r"^text_decoder\.head\.weight$", COLUMN),
    (r"^text_decoder\.head\.(bias|scale)$", ("tensor",)),
    (r"^text_decoder\.head_new\.weight$", (None, "fsdp")),
    # --- kept whole over tensor: the SPM's 1x1 convs, the VAE's attention
    (r"\.adapter_spm\.fc1\.weight$", (None, "fsdp")),
    (r"\.adapter_spm\.fc2\.weight$", ("fsdp", None)),
    (r"\.adapter_spm\.", ()),
    (r"^image_decoder\.vae\..*\.to_[qkv]\.weight$", (None, "fsdp")),
    (r"^image_decoder\.vae\..*\.to_out\.weight$", ("fsdp", None)),
    (r"\.dynamic_offset_mask\.weight$", (None, "fsdp")),
    # --- the deformable attentions by head: head-major rows, ignore token
    (r"\.(sampling_offsets|attention_weights)\.(weight|bias)$",
     ("tensor", None)),
    (r"\.ignore_token$", ("tensor",)),
    # --- the ConvFFN's depthwise conv by channel, with fc1
    (r"\.dwconv\.weight$", ("tensor", None, None, None)),
    (r"\.dwconv\.bias$", ("tensor",)),
    # --- every other pair: column layers with their biases, row layers
    (r"\." + _COL + r"\.weight$", COLUMN),
    (r"\." + _COL + r"\.bias$", ("tensor",)),
    (r"\." + _ROW + r"\.weight$", ROW),
    (r"\.query_relpos\.weight$", (None, "fsdp")),
    # --- everything else (convs, norms, row biases, embeddings of
    # positions)
    (r".*", ()),
)
# a dim cut over tensor as this many equal blocks, each cut alike: GEGLU's
# ff_in is [value | gate], each rank [value_r | gate_r]
BLOCKS = ((r"\.ff_in\.(weight|bias)$", 2),)

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


def tensor_pairs(model: nn.Module):
    """``(module, group attribute, units, parameter names)`` of every
    Megatron pair of ``model``: each module with a ``tensor_pairs()``
    method names its pairs there, as ``(attribute, units, leaves)``: the
    attribute that holds the pair's ``tensor`` group once cut, its heads or
    hidden columns (read on the whole model) and the submodules and
    parameters that make it up."""
    for mname, module in model.named_modules():
        pairs = getattr(module, "tensor_pairs", None)
        if pairs is None:
            continue
        prefix = f"{mname}." if mname else ""
        names = [prefix + n for n, _ in module.named_parameters()]
        for attr, units, leaves in pairs():
            yield module, attr, units, [
                n for n in names if any(
                    n == prefix + leaf or n.startswith(f"{prefix}{leaf}.")
                    for leaf in leaves)]


def plan(model: nn.Module, mesh, rules=DEFAULT_RULES) -> dict:
    """``{name: Placement}`` of every parameter of the whole ``model`` on
    ``mesh``: `placement_for` each, with the tensor cut of every pair whose
    units ``tensor`` does not divide dropped (the pair kept whole)."""
    sizes = axis_sizes(mesh)
    out = {n: placement_for(n, p.shape, sizes, rules)
           for n, p in model.named_parameters()}
    for _, _, units, names in tensor_pairs(model):
        if units % sizes["tensor"]:
            for n in names:
                out[n] = out[n]._replace(tensor=None)
    return out


def tensor_blocks(name: str) -> int:
    """The equal blocks ``name``'s tensor dim is cut as (`BLOCKS`; 1: one
    contiguous cut)."""
    return next((n for pattern, n in BLOCKS if re.search(pattern, name)), 1)


def tensor_part(x, name: str, dim: int, rank: int, parts: int):
    """Rank ``rank``'s part of ``x`` (of parameter ``name``) cut along
    ``dim`` into ``parts``: of each of its `tensor_blocks`, the rank's
    chunk, concatenated."""
    import torch

    return torch.cat([b.chunk(parts, dim)[rank]
                      for b in x.chunk(tensor_blocks(name), dim)], dim)


def tensor_join(xs: Sequence, name: str, dim: int):
    """The whole tensor of ``name`` from every rank's part ``xs`` (the
    inverse of `tensor_part`)."""
    import torch

    n = tensor_blocks(name)
    blocks = [x.chunk(n, dim) for x in xs]
    return torch.cat([b[i] for i in range(n) for b in blocks], dim)


def rank_bytes(model: nn.Module, mesh, pattern: str = "") -> int:
    """The bytes of the parameters whose names ``pattern`` matches
    (`re.search`) that one rank holds under the plan on ``mesh`` (a
    `DeviceMesh` or a mapping of axis sizes: the model is whole, and may
    be on ``meta``)."""
    sizes = axis_sizes(mesh)
    placed = plan(model, sizes)
    total = 0
    for name, p in model.named_parameters():
        if not re.search(pattern, name):
            continue
        pl = placed[name]
        n = p.numel()
        for axis, dim in (("tensor", pl.tensor), ("fsdp", pl.fsdp)):
            if dim is not None:
                n //= sizes[axis]
        total += n * p.element_size()
    return total


def shard_fsdp(model: nn.Module, mesh, rules=DEFAULT_RULES,
               train: bool = False) -> int:
    """FSDP2 over the mesh's ``fsdp`` dim on each module of `FSDP_UNITS`:
    the parameters the plan shards along their plan dim, the others kept
    whole; each unit's `FSDP_METHODS` registered.  With ``train``, each
    unit reduce-scatters its gradients as a sum in fp32.  Returns the units
    made (0 where ``fsdp`` is 1).  A parameter the plan shards outside
    every unit raises."""
    import torch
    from torch.distributed.fsdp import (MixedPrecisionPolicy, fully_shard,
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
        mp = (MixedPrecisionPolicy(reduce_dtype=torch.float32) if train
              else MixedPrecisionPolicy())
        fully_shard(unit, mesh=mesh["fsdp"], reshard_after_forward=True,
                    shard_placement_fn=lambda p, s=shard: Shard(s[p]),
                    ignored_params=ignored, mp_policy=mp)
        if train:
            # a plain SUM: no average and no PREMUL_SUM (gloo has none)
            unit.set_gradient_divide_factor(1.0)
            unit.set_force_sum_reduction_for_comms(True)
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


def row_sum(x, mesh):
    """``x`` summed in place over the ranks that hold rows of a batch: over
    ``fsdp``, then over ``data`` (a fixed order; an axis of size 1 is
    skipped).  Returns ``x``."""
    import torch.distributed as dist

    sizes = axis_sizes(mesh)
    for axis in ("fsdp", "data"):
        if sizes[axis] > 1:
            dist.all_reduce(x, group=mesh.get_group(axis))
    return x


class RankLayout:
    """Where this rank's parameters lie in the global ones on ``mesh``:
    ``cuts`` (`parallel.tensor.tensor_cuts`, taken on the whole model)
    gives the dim each is cut along over ``tensor``; FSDP2's placement, the
    dim each `DTensor` is sharded along over ``fsdp``.  `local` takes a
    rank's part of a global tensor, `gather` makes the global one of the
    ranks' parts (a collective: every rank calls it, in the same order)."""

    def __init__(self, model: nn.Module, mesh, cuts: Mapping[str, int]):
        from torch.distributed.tensor import DTensor, Shard

        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.cuts = dict(cuts)
        self.fsdp = {}
        for name, p in model.named_parameters():
            if isinstance(p, DTensor):
                dims = [pl.dim for pl in p.placements if isinstance(pl, Shard)]
                if dims:
                    self.fsdp[name] = dims[0]

    def _rank(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    def split_axes(self, name: str) -> Tuple[str, ...]:
        """The axes ``name`` is split over (``fsdp``, ``tensor``)."""
        return tuple(a for a, d in (("fsdp", self.fsdp), ("tensor", self.cuts))
                     if name in d)

    def local(self, name: str, full):
        """This rank's part of the global tensor ``full`` of ``name``."""
        x = full
        if name in self.cuts:
            x = tensor_part(x, name, self.cuts[name], self._rank("tensor"),
                            self.sizes["tensor"])
        if name in self.fsdp:
            x = x.chunk(self.sizes["fsdp"], self.fsdp[name])[
                self._rank("fsdp")]
        return x.contiguous()

    def gather(self, name: str, x):
        """The global tensor of ``name`` from each rank's part ``x``."""
        import torch
        import torch.distributed as dist

        for axis, dims in (("fsdp", self.fsdp), ("tensor", self.cuts)):
            if name in dims:
                x = x.contiguous()
                parts = [torch.empty_like(x)
                         for _ in range(self.sizes[axis])]
                dist.all_gather(parts, x, group=self.mesh.get_group(axis))
                x = (tensor_join(parts, name, dims[name]) if axis == "tensor"
                     else torch.cat(parts, dims[name]))
        return x
