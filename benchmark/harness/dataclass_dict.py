"""A configuration's nested dict -> the model code's nested frozen
dataclasses (the program's, or the reference's copy of them)."""

from __future__ import annotations

import dataclasses
import typing


def _convert(tp, value):
    if value is None:
        return None
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:
        inner = [a for a in args if a is not type(None)]
        return _convert(inner[0], value)
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, value)
    if origin in (tuple, typing.Tuple) or isinstance(value, list):
        return tuple(_convert(args[0] if args else None, v) for v in value)
    return value


def from_dict(cls, d: dict):
    """``cls(**d)`` with nested dataclass fields and tuples rebuilt; an
    unknown key raises."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: _convert(hints[k], v) for k, v in d.items()})


def with_dtype(d, dtype: str):
    """A copy of config dict ``d`` with every dtype field set to
    ``dtype``."""
    if isinstance(d, dict):
        return {k: (dtype if k in ("dtype", "vae_decode_dtype")
                    and isinstance(v, str) else with_dtype(v, dtype))
                for k, v in d.items()}
    return d
