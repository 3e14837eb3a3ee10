"""The model for the inference and evaluation entry points (counterpart of
`mm_interleaved_tpu/utils/checkpoint.py`).

Without a checkpoint: the seeded model of `build_model`.  With one: a
checkpoint of the port's `Trainer` (``step_{n}.pt``), whose trainable fp32
masters are loaded over the frozen weights rebuilt from the seed it was
trained at (its ``seed``, else ``seed``).  The JAX package's orbax
directories and converted HF weights are refused: the converters are
ROADMAP.md §1 item 5.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.mm_interleaved import build_model


def load_model(model_cfg, device, checkpoint: Optional[str] = None,
               seed: int = 0, dtype: Optional[torch.dtype] = None):
    """The model in eval mode on ``device`` (``dtype``: the LLM's compute
    dtype by default)."""
    state = None
    if checkpoint:
        if os.path.isdir(checkpoint):
            raise NotImplementedError(
                f"checkpoint {checkpoint!r} is a directory (an orbax "
                "checkpoint of the JAX package); the port reads its own "
                "Trainer checkpoints only, the converters are ROADMAP.md §1 "
                "item 5")
        state = torch.load(checkpoint, map_location="cpu", weights_only=False)
        seed = int(state.get("seed", seed))
    model = build_model(model_cfg, device, dtype, seed=seed)
    if state is not None:
        params = dict(model.named_parameters())
        missing = set(state["params"]) - set(params)
        if missing:
            raise KeyError(f"checkpoint leaves the model lacks: "
                           f"{sorted(missing)[:5]}")
        with torch.no_grad():
            for name, x in state["params"].items():
                params[name].copy_(x)
    return model.eval()


def entry_model(model_cfg, device, checkpoint: Optional[str] = None,
                model=None):
    """The entry points' model: ``model`` when the caller passes one built
    from the same config (it must not come with a checkpoint), else
    `load_model`."""
    if model is None:
        return load_model(model_cfg, device, checkpoint)
    if checkpoint or model.cfg != model_cfg:
        raise ValueError("a model passed in must come from the config's "
                         "model section, without a checkpoint")
    return model.eval()
