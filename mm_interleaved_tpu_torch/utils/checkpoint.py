"""The model for the inference and evaluation entry points (counterpart of
`mm_interleaved_tpu/utils/checkpoint.py`), and the port's full checkpoint.

`load_model` gives, without a checkpoint, the seeded model of
`build_model`; with one, either

  * a full checkpoint (`save_full_checkpoint`, what
    ``python -m mm_interleaved_tpu_torch.convert_checkpoint`` writes): every
    weight of the model, loaded strictly (names and shapes) into the
    model's dtype, one tensor at a time from the memory-mapped file; or
  * a checkpoint of the port's `Trainer` (``step_{n}.pt``), whose trainable
    fp32 masters are loaded over the frozen weights: those of the full
    checkpoint the run was warm-started from (its ``load_from`` record,
    `read_recorded_full`), else rebuilt from the seed it was trained at
    (its ``seed``, else ``seed``).

The two are told apart by the full checkpoint's ``format`` entry.  Each
full checkpoint carries a random ``id``; a run warm-started from one
records its path, size and ``id``, and refuses to go on from a file that
is missing or is another.  The JAX
package's orbax directories are refused: the port converts the released
torch weights itself.
"""

from __future__ import annotations

import os
import uuid
import zipfile
from typing import Any, Dict, Optional

import torch

from ..models.mm_interleaved import allocate_model, build_model

FULL_FORMAT = "mm_interleaved_tpu_torch/full-checkpoint/1"


def save_full_checkpoint(model, path: str, **meta: Any) -> int:
    """Every parameter of ``model`` in its own dtype, with ``format``,
    ``dtype``, a random ``id`` and ``meta``, to ``path`` (written through a
    temporary file); returns its size.  Tensors on the card are copied to the host one at a
    time as they are written."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    dtypes = sorted({str(p.dtype).replace("torch.", "") for p in params.values()})
    tmp = path + ".tmp"
    torch.save(dict(format=FULL_FORMAT, dtype=",".join(dtypes),
                    id=uuid.uuid4().hex, params=params, **meta), tmp)
    os.replace(tmp, path)
    return os.path.getsize(path)


def _refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"checkpoint {path!r} is a directory (an orbax checkpoint of the "
            "JAX package): convert the released torch weights with python -m "
            "mm_interleaved_tpu_torch.convert_checkpoint")


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint of the port (a `torch.save` zip), its tensors
    memory-mapped."""
    _refuse_directory(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path!r} is not a checkpoint of the port (not a "
                         "torch.save file)")
    return torch.load(path, map_location="cpu", mmap=True, weights_only=False)


def read_full_checkpoint(path: str) -> Dict[str, Any]:
    """A full checkpoint (`save_full_checkpoint`); anything else raises."""
    state = read_checkpoint(path)
    if not isinstance(state, dict) or state.get("format") != FULL_FORMAT:
        raise ValueError(
            f"{path!r} is not a full checkpoint of the port (python -m "
            "mm_interleaved_tpu_torch.convert_checkpoint writes one)")
    return state


def full_checkpoint_record(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """What a run warm-started from the full checkpoint ``state`` (read from
    ``path``) keeps of it: the absolute path, the size and the ``id``."""
    return dict(path=os.path.abspath(path), bytes=os.path.getsize(path),
                id=state["id"])


def read_recorded_full(record: Dict[str, Any]) -> Dict[str, Any]:
    """The full checkpoint of ``record`` (`full_checkpoint_record`); raises
    when it is missing or is not the file recorded (another size or
    ``id``): the frozen weights of the run cannot be rebuilt without it."""
    path = record["path"]
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"the run was warm-started from {path!r}, which is gone: its "
            "frozen weights cannot be rebuilt without it")
    state = read_full_checkpoint(path)
    if (os.path.getsize(path) != record["bytes"]
            or state.get("id") != record["id"]):
        raise ValueError(
            f"{path!r} is not the full checkpoint the run was warm-started "
            f"from (id {state.get('id')} of {os.path.getsize(path)} bytes, "
            f"recorded {record['id']} of {record['bytes']})")
    return state


def load_model(model_cfg, device, checkpoint: Optional[str] = None,
               seed: int = 0, dtype: Optional[torch.dtype] = None):
    """The model in eval mode on ``device`` (``dtype``: the LLM's compute
    dtype by default)."""
    if not checkpoint:
        return build_model(model_cfg, device, dtype, seed=seed).eval()
    state = read_checkpoint(checkpoint)
    if isinstance(state, dict) and state.get("format") == FULL_FORMAT:
        model = allocate_model(model_cfg, device, dtype)
        model.load_state_dict(state["params"], strict=True)
        return model.eval()
    if not (isinstance(state, dict) and "opt_state" in state):
        raise ValueError(f"{checkpoint!r} is neither a full checkpoint nor a "
                         "Trainer checkpoint of the port")
    if state.get("load_from"):
        model = allocate_model(model_cfg, device, dtype)
        model.load_state_dict(read_recorded_full(state["load_from"])["params"],
                              strict=True)
    else:
        model = build_model(model_cfg, device, dtype,
                            seed=int(state.get("seed", seed)))
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
