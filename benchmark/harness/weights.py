"""The configuration's weights, made by the benchmark from ``--seed`` on
the device, in the dtype they are served in.

Parameters fall into groups (a numbered layer, or a module's leaves that
sit in no numbered layer); each group is one ``randn`` of its whole size
from a generator seeded by the run's seed and the group's name, and each
leaf is a scaled view of its slice:

* a matrix or convolution kernel ``z / sqrt(fan_in)``;
* a bias ``0.02 z``;
* a norm's 1-D weight ``1 + 0.02 z``;
* any other vector or scalar (gates, layer scales, special embeddings)
  ``0.5 z``, so that no gate or residual branch is zero and every layer
  adds to the output.

The program and the reference call `make_group` on the same names and
shapes and receive the same bits; neither takes the other's weights."""

from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...]]


def group_key(name: str) -> str:
    parts = name.split(".")
    for i, p in enumerate(parts[:-1]):
        if p.isdigit():
            return ".".join(parts[:i + 1])
    return ".".join(parts[:min(2, max(1, len(parts) - 1))])


def groups(leaves: Iterable[Leaf]) -> "OrderedDict[str, List[Leaf]]":
    out: "OrderedDict[str, List[Leaf]]" = OrderedDict()
    for name, shape in leaves:
        out.setdefault(group_key(name), []).append((name, tuple(shape)))
    return out


def group_seed(seed: int, key: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(key.encode())) % (1 << 62)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _scale(name: str, z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return z * 0.02
    if z.dim() >= 2:
        return z * (_numel(z.shape[1:]) ** -0.5)
    if leaf == "weight":
        return z * 0.02 + 1.0
    return z * 0.5


def make_group(seed: int, key: str, leaves: List[Leaf], device,
               dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of one group's leaves, each in its own storage."""
    total = sum(_numel(s) for _, s in leaves)
    g = torch.Generator(device=device)
    g.manual_seed(group_seed(seed, key))
    z = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, start = {}, 0
    for name, shape in leaves:
        n = _numel(shape)
        out[name] = _scale(name, z[start:start + n].view(shape))
        start += n
    del z
    return out


def fill(model: torch.nn.Module, seed: int, transform=None) -> None:
    """Write the seeded weights into ``model``'s parameters in place, one
    group at a time; ``transform(name, bf16 tensor) -> tensor`` may change
    a leaf first (the reference's dequantization or a control's
    rounding).  The leaves are made in bf16, the served dtype, and cast to
    each parameter's dtype."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    with torch.no_grad():
        for key, leaves in groups((n, p.shape)
                                  for n, p in params.items()).items():
            made = make_group(seed, key, leaves, dev, torch.bfloat16)
            for name, t in made.items():
                if transform is not None:
                    t = transform(name, t)
                params[name].copy_(t)
            del made
