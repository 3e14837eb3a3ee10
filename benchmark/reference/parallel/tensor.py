"""The tensor-parallel seams of the model code, on one device: each is the
identity (or the plain layer) that the program's helpers reduce to without
a process group."""

from __future__ import annotations

import torch


def tensor_enter(x, group):
    return x


def tensor_all_reduce(x, group):
    return x


def tensor_all_gather(x, group):
    return x


def partial_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype


def row_parallel(layer, x, group):
    return layer(x)


def entered_layer_norm(norm, x, group):
    return norm(x)
