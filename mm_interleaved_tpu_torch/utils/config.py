"""YAML config loading over dataclass presets.

Replaces the reference's mmcv-Config-over-argparse system
(`utils/parse_args.py:32-70`): a YAML file selects a model preset
(tiny/small/base/flagship) and overrides nested dataclass fields; the merged
config is dumped to the output dir for reproducibility (parse_args.py:50-51).

Override syntax: nested dicts matching the dataclass field tree, e.g.

    model:
      preset: base
      overrides:
        llm: {num_hidden_layers: 12}
        seq_len: 1024
    training:
      learning_rate: 1.0e-4

The port's copy of `mm_interleaved_tpu/utils/config.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import yaml


def apply_overrides(dc: Any, overrides: Dict[str, Any]):
    """Recursively `dataclasses.replace` nested frozen dataclasses."""
    if not dataclasses.is_dataclass(dc):
        return overrides
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc)}
    for k, v in overrides.items():
        assert k in fields, f"unknown config field {type(dc).__name__}.{k}"
        cur = getattr(dc, k)
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            kwargs[k] = apply_overrides(cur, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v) if isinstance(cur, tuple) else v
        else:
            kwargs[k] = v
    return dataclasses.replace(dc, **kwargs)


def build_model_config(model_cfg: Dict[str, Any]):
    from ..configs import base_config, flagship_config, small_config, tiny_config

    presets = {
        "tiny": tiny_config,
        "small": small_config,
        "base": base_config,
        "flagship": flagship_config,
    }
    preset = model_cfg.get("preset", "base")
    kwargs = model_cfg.get("preset_kwargs", {})
    cfg = presets[preset](**kwargs)
    return apply_overrides(cfg, model_cfg.get("overrides", {}))


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def dump_config(cfg: Dict[str, Any], output_dir: str):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)


def config_to_json(dc: Any) -> str:
    return json.dumps(dataclasses.asdict(dc), default=str, indent=2)
