"""Tensor parallelism: Megatron pairs of local shards in plain tensors,
over the whole model.

The port's CUDA kernels take plain contiguous tensors and read the head
count from the shapes they get, so a tensor-parallel layer holds plain
local shards, not `DTensor`s.  A column-parallel layer keeps whole heads
(or whole hidden columns) on each rank; only per-head or per-column work
runs between it and its row-parallel partner (`row_parallel`), whose
partial output `tensor_all_reduce` sums over the mesh's ``tensor`` group
before the row layer's bias is added, once (an fp32 partial is formed and
summed in fp64, `partial_dtype`).  Without a group (``tensor``
is 1, or a pair the plan keeps whole) the pair is the whole layers.

In training both halves of a pair are Megatron's conjugate collectives,
each an autograd function: `tensor_all_reduce` is **g** (the sum in the
forward, the identity in the backward) and `tensor_enter` is **f** (the
identity in the forward, the sum of the input gradient over ``tensor`` in
the backward).  ``f`` sits at the input of every column-parallel group, so
that the gradient reaching the replicated layers before it is the whole
one on every rank (a whole weight applied to each rank's heads, the
Q-Formers' per-head q/k LayerNorm, passes ``f`` too).  Without a group
both are the identity.

`shard_tensor_parallel` cuts the whole model's weights in place along the
dims the placement plan (`parallel.partition.plan`) gives them over
``tensor``, and hands each pair's module its group (the attribute its
``tensor_pairs()`` names).  The pairs:

  * the LLM: `LlamaAttention` ``q/k/v_proj`` by head, ``o_proj`` by row;
    `LlamaMLP` ``gate/up_proj`` by column, ``down_proj`` by row;
  * every MMFS (the LLM's and MMFSNet's) and the adapter's `MSDeformAttn`:
    ``value_proj`` (weight and bias) by head, the head-major rows of
    ``sampling_offsets`` and ``attention_weights`` (weight and bias) and
    ``ignore_token`` to the local heads, ``output_proj`` by row;
  * the ViT (`ViTLayer`): ``q/k/v_proj`` by head, ``out_proj`` by row,
    ``fc1`` / ``fc2``; the adapter's `ConvFFN`: ``fc1`` by column,
    ``dwconv`` by channel with it, ``fc2`` by row;
  * the Q-Formers (`_MHA`, `PerceiverLayer`): ``query/key/value`` by head,
    ``output`` by row, ``intermediate`` / ``ffn_output``;
  * the UNet (`TransformerBlock`): ``attn[12]_[qkv]`` by head,
    ``attn[12]_out`` by row, ``ff_in`` as ``[value_r | gate_r]``,
    ``ff_out`` by row;
  * the vocabulary: ``embed_tokens`` by row (each rank looks up the ids it
    holds, zeroes the others, and g sums: one rank holds each id, so the
    sum is exact) and the text ``head`` by row, its logits all-gathered
    along the vocabulary (`tensor_all_gather`, whose backward keeps the
    rank's slice).

An int8 layer (`ops.quant.QLinear`) is cut after it was quantized whole: a
row shard quantized alone would take its absmax over a part of the
reduction axis and get other scales.  A column layer's codes and scales
are cut by row, a row layer's codes by column with its scales whole, so
every code and scale is the whole layer's, bit for bit.  The flagship's
local shapes at ``tensor = 2`` (K = 5120 / 2560 / 6912) stay multiples of
16, so every local projection keeps `int8_linear`'s "wgmma" body.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class _SumOverTensor(torch.autograd.Function):
    """Megatron's g: the sum over ``group`` (in place), the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterTensor(torch.autograd.Function):
    """Megatron's f: the identity, the input gradient summed over
    ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def tensor_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of a row-parallel layer's partial output ``x`` over the
    ``tensor`` group, in place (g: its gradient passes through whole);
    ``x`` itself without a group."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverTensor.apply(x, group)
    import torch.distributed as dist

    dist.all_reduce(x, group=group)
    return x


def tensor_enter(x: torch.Tensor, group) -> torch.Tensor:
    """The input ``x`` of a column-parallel group (f): ``x`` in the
    forward; in the backward its gradient, summed over the ``tensor``
    group."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _EnterTensor.apply(x, group)


class _GatherOverTensor(torch.autograd.Function):
    """The ranks' parts concatenated along the last dim; the backward keeps
    this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.rank = dist.get_rank(group)
        ctx.n = x.shape[-1]
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.n, ctx.n), None


def _gather_last(x, group):
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=-1)


def tensor_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last dim in rank order (a
    vocabulary-parallel head's logits); ``x`` itself without a group."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherOverTensor.apply(x, group)
    return _gather_last(x, group)


def partial_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a row-parallel partial product is formed and summed in:
    fp64 for fp32, whose sum is then rounded once, after the bias, as the
    whole layer rounds its dot product once (so a cut fp32 model computes
    the whole one's numbers to that rounding); the compute dtype itself
    otherwise (bf16: an fp32 product would run off the tensor cores' bf16
    rate, so each partial is rounded to bf16 before the sum)."""
    return torch.float64 if dtype == torch.float32 else dtype


def row_parallel(layer: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel Linear ``layer`` (its input columns this rank's) on
    ``x``: the partial product (in `partial_dtype`) summed over ``group``
    (g), the bias added once after the sum; ``layer(x)`` without a
    group."""
    if group is None:
        return layer(x)
    wide = partial_dtype(x.dtype)
    out = tensor_all_reduce(F.linear(x.to(wide), layer.weight.to(wide)),
                            group)
    if layer.bias is not None:
        out = out + layer.bias.to(wide)
    return out.to(x.dtype)


def entered_layer_norm(norm: nn.LayerNorm, x: torch.Tensor,
                       group) -> torch.Tensor:
    """``norm`` over each of this rank's heads of ``x``, its whole weight
    and bias passing f (their gradients summed over every rank's heads);
    ``norm(x)`` without a group."""
    if group is None:
        return norm(x)
    return F.layer_norm(x, norm.normalized_shape,
                        tensor_enter(norm.weight, group),
                        tensor_enter(norm.bias, group), norm.eps)


def _narrow(p: torch.Tensor, name: str, dim: int, rank: int,
            parts: int) -> nn.Parameter:
    from .partition import tensor_part

    shard = tensor_part(p.detach(), name, dim, rank, parts).clone(
        memory_format=torch.contiguous_format)
    return nn.Parameter(shard, requires_grad=p.requires_grad)


def _check_divides(model, parts: int) -> None:
    """Whole heads and whole hidden columns of the LLM on every rank, or
    raise (a tower pair that ``tensor`` does not divide is kept whole by
    the plan)."""
    llm = model.cfg.llm
    widths = {"attention heads": llm.num_attention_heads,
              "key/value heads": llm.kv_heads,
              "MLP hidden columns": llm.intermediate_size,
              "MMFS heads": llm.mmfs_heads}
    for what, n in widths.items():
        if n % parts:
            raise ValueError(f"tensor {parts} does not divide the LLM's "
                             f"{n} {what}")


def tensor_cuts(model: nn.Module, mesh) -> dict:
    """``{name: dim}`` of the parameters `shard_tensor_parallel` cuts on
    ``mesh``, read on the whole model (empty where ``tensor`` is 1)."""
    from .partition import axis_sizes, plan

    if axis_sizes(mesh)["tensor"] == 1:
        return {}
    return {n: pl.tensor for n, pl in plan(model, mesh).items()
            if pl.tensor is not None}


def _reshape_module(module: nn.Module) -> None:
    """A cut module's size attributes from its local weight."""
    w = module.weight
    if isinstance(module, nn.Embedding):
        module.num_embeddings = w.shape[0]
    elif isinstance(module, nn.Conv2d):
        # a depthwise conv cut by channel
        module.in_channels = module.out_channels = module.groups = w.shape[0]
    elif hasattr(module, "out_features"):
        module.out_features, module.in_features = w.shape


def apply_tensor_cuts(model: nn.Module, cuts: dict, rank: int, parts: int,
                      group) -> None:
    """Cut ``model``'s parameters of ``cuts`` in place to rank ``rank``'s
    parts of ``parts``, and set ``group`` on the attribute of every pair
    with a parameter cut (the pairs of `parallel.partition.tensor_pairs`,
    read before the cut)."""
    from .partition import tensor_pairs

    cut_pairs = [(m, attr) for m, attr, _, names in tensor_pairs(model)
                 if any(n in cuts for n in names)]
    for name, dim in cuts.items():
        mname, leaf = name.rsplit(".", 1)
        module = model.get_submodule(mname)
        setattr(module, leaf, _narrow(getattr(module, leaf), name, dim, rank,
                                      parts))
        if leaf == "weight":
            _reshape_module(module)
    for module, attr in cut_pairs:
        setattr(module, attr, group)


def shard_tensor_parallel(model: nn.Module, mesh) -> dict:
    """Cut ``model`` (whole) in place to this rank's shards on ``mesh``'s
    ``tensor`` dim (`tensor_cuts`), and give each cut pair's module the
    group it sums over.  Returns the cuts (empty where ``tensor`` is 1)."""
    from .partition import axis_sizes

    cuts = tensor_cuts(model, mesh)
    if not cuts:
        return cuts
    parts = axis_sizes(mesh)["tensor"]
    _check_divides(model, parts)
    apply_tensor_cuts(model, cuts, mesh.get_local_rank("tensor"), parts,
                      mesh.get_group("tensor"))
    return cuts
