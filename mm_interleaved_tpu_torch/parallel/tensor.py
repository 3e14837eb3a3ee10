"""Tensor parallelism of the LLM: Megatron pairs of local shards in plain
tensors.

The port's CUDA kernels take plain contiguous tensors and read the head
count from the shapes they get, so a tensor-parallel layer holds plain
local shards, not `DTensor`s.  A column-parallel layer keeps whole heads
(or whole MLP hidden columns) on each rank; only per-head or per-column
work runs between it and its row-parallel partner, whose partial output
`tensor_all_reduce` sums over the mesh's ``tensor`` group.  That sum is
the one collective of the forward; without a group (``tensor`` is 1) it is
the identity.

In training both halves of a pair are Megatron's conjugate collectives,
each an autograd function: `tensor_all_reduce` is **g** (the sum in the
forward, the identity in the backward) and `tensor_enter` is **f** (the
identity in the forward, the sum of the input gradient over ``tensor`` in
the backward).  ``f`` sits at the input of every column-parallel group, so
that the gradient reaching the replicated layers before it is the whole
one on every rank.  Without a group both are the identity.

`shard_tensor_parallel` cuts the full weights in place along the dims the
placement plan (`parallel.partition.placement_for`) gives them over
``tensor``:

  * `LlamaAttention`: ``q/k/v_proj`` by head, ``o_proj`` by row;
  * `LlamaMLP`: ``gate/up_proj`` by column, ``down_proj`` by row;
  * the LLM's MMFS: ``value_proj`` (weight and bias) by head, the
    head-major rows of ``sampling_offsets`` ``[H, P, 2]`` and
    ``attention_weights`` ``[H, L, P + 1]`` (weight and bias) and
    ``ignore_token`` ``[H, d / H]`` to the local heads, ``output_proj`` by
    row (its bias added once, after the sum).

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


def _narrow(p: torch.Tensor, dim: int, rank: int, parts: int) -> nn.Parameter:
    n = p.shape[dim] // parts
    shard = p.detach().narrow(dim, rank * n, n).clone(
        memory_format=torch.contiguous_format)
    return nn.Parameter(shard, requires_grad=p.requires_grad)


def _check_divides(model, parts: int) -> None:
    """Whole heads and whole hidden columns on every rank, or raise."""
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
    from .partition import axis_sizes, placement_for

    sizes = axis_sizes(mesh)
    if sizes["tensor"] == 1:
        return {}
    out = {}
    for name, p in model.mm_decoder.layers.named_parameters(
            prefix="mm_decoder.layers"):
        dim = placement_for(name, p.shape, sizes).tensor
        if dim is not None:
            out[name] = dim
    return out


def shard_tensor_parallel(model: nn.Module, mesh) -> int:
    """Cut the LLM's tensor-parallel layers of ``model`` in place to this
    rank's shards on ``mesh``'s ``tensor`` dim (`tensor_cuts`), and give
    their modules the group they sum over.  Returns the parameters cut (0
    where ``tensor`` is 1)."""
    from ..models.llama import LlamaAttention, LlamaMLP
    from ..models.mmfs import MMFS
    from .partition import axis_sizes

    cuts = tensor_cuts(model, mesh)
    if not cuts:
        return 0
    parts = axis_sizes(mesh)["tensor"]
    _check_divides(model, parts)
    rank = mesh.get_local_rank("tensor")
    for name, dim in cuts.items():
        mname, leaf = name.rsplit(".", 1)
        module = model.get_submodule(mname)
        setattr(module, leaf, _narrow(getattr(module, leaf), dim, rank, parts))
        if leaf == "weight" and hasattr(module, "out_features"):
            module.out_features, module.in_features = module.weight.shape
    group = mesh.get_group("tensor")
    for module in model.mm_decoder.layers.modules():
        if isinstance(module, (LlamaAttention, LlamaMLP, MMFS)):
            module.tensor_group = group
    return len(cuts)
