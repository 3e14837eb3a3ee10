"""Carry a JAX parameter tree over to the port's ``state_dict``.

Input: the ``params`` tree of a `mm_interleaved_tpu` model (or of one of
its submodules) as nested dicts of numpy arrays.  Output: a dict of torch
tensors keyed as the port's modules name them, for
``load_state_dict(strict=True)``.

  * Dense ``[in, out]`` -> Linear ``[out, in]``;
  * Conv HWIO -> OIHW (the depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``);
  * ``adapter_up`` (ConvTranspose ``[kh, kw, in, out]``) -> torch
    ``[in, out, kh, kw]``, spatially flipped: flax's transposed conv does
    not mirror its kernel, torch's does (the inverse of
    `mm_interleaved_tpu/utils/convert_ref.py`);
  * ``scan_layers`` stacks ``block/layer_{j}`` (leading ``n_blocks`` axis)
    are unstacked to ``layers_{b * freq + j}``;
  * LayerNorm and GroupNorm ``scale`` and Embed ``embedding`` become
    ``weight``; bare params (``soi_token``, ``gate``, ``gamma``,
    ``adapter_level_embed``, ``ignore_token``, ``queries``,
    ``neg_prompt_embeds``, ...) keep their names;
  * the image decoder needs no renames: the port's UNet, VAE and MMFSNet
    keep the JAX module names, and the fused GEGLU's ``ff_in``/``ff_out``
    params are ``kernel``/``bias`` like any Dense.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"(^|/)layers_(\d+)(?=/)"), r"\1layers/\2"),
    (re.compile(r"(^|/)interactions_(\d+)_injector(?=/)"), r"\1injectors/\2"),
    (re.compile(r"(^|/)interactions_(\d+)_extractor(?=/)"), r"\1extractors/\2"),
    (re.compile(r"(^|/)interactions_\d+_extra_extractor_(\d+)(?=/)"),
     r"\1extra_extractors/\2"),
    (re.compile(r"(^|/)_ConvLNRelu_(\d+)/Conv_0(?=/)"), r"\1convs/\2/conv"),
    (re.compile(r"(^|/)_ConvLNRelu_(\d+)/LayerNorm_0(?=/)"), r"\1convs/\2/norm"),
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unstack_blocks(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``.../block/layer_{j}/...`` with a leading n_blocks axis ->
    ``.../layers_{b * freq + j}/...``."""
    pat = re.compile(r"^(?:(.*)/)?block/layer_(\d+)/(.*)$")
    stacked = {p: pat.match(p) for p in flat if "block/layer_" in p}
    if not stacked:
        return flat
    freq = 1 + max(int(m.group(2)) for m in stacked.values())
    out = {p: a for p, a in flat.items() if p not in stacked}
    for p, m in stacked.items():
        root, j, rest = m.group(1), int(m.group(2)), m.group(3)
        arr = flat[p]
        for b in range(arr.shape[0]):
            key = f"layers_{b * freq + j}/{rest}"
            out[f"{root}/{key}" if root else key] = arr[b]
    return out


def _convert_leaf(path: str, arr: np.ndarray):
    parts = path.split("/")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4 and parent == "adapter_up":
            arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        elif arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        else:
            raise ValueError(f"unexpected kernel rank at {path}: {arr.shape}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    parts[-1] = leaf
    return ".".join(parts), arr


def convert_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params tree (nested dicts of arrays) -> the port's state dict."""
    flat = _unstack_blocks(_flatten(params))
    out = {}
    for path, arr in flat.items():
        for pat, repl in _RENAMES:
            path = pat.sub(repl, path)
        name, arr = _convert_leaf(path, arr)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping) -> None:
    """Convert ``params`` and load them into ``module`` with strict=True."""
    module.load_state_dict(convert_params(params), strict=True)
