"""Name maps: how a torch checkpoint's tensors fill the port's parameters.

A converter (`convert_hf`, `convert_sd`, `convert_ref`,
`models.clip_text`, `utils.inception_v3`) is a `NameMap`: for each port
parameter, the `Entry` that fills it, the source keys it reads and the
transform applied to them.  The source is torch, like the port, so almost
every entry is the tensor as it is (Linear ``[out, in]``, Conv OIHW and
ConvTranspose ``[in, out, kh, kw]`` all carry over); the transforms are a
flattened bare parameter, a 1x1 convolution read as a Linear, the mean-padded
embedding rows and the TextDecoder heads built from ``lm_head``.

`check_coverage` holds a map to a source and a model exactly: a source key
that no entry reads and no skip pattern names raises, so does a map entry
the model lacks and, for a full map, a model parameter no entry fills.
`stream_into` then fills the parameters one entry at a time, each source
tensor moved to the parameter's device before its transform, so the host
holds about one tensor at a time.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Entry:
    """What fills one port parameter: ``fn(*[sd[k] for k in keys])``, or the
    one source tensor as it is when ``fn`` is None.  ``source_shape`` maps
    the parameter's shape to that of ``keys[0]`` in a checkpoint where the
    two differ (a writer of synthetic sources reads it)."""

    keys: Tuple[str, ...]
    fn: Optional[Callable[..., torch.Tensor]] = None
    source_shape: Optional[Callable[[Shape], Shape]] = None


NameMap = Dict[str, Entry]


def same(key: str) -> Entry:
    return Entry((key,))


def weight_bias(dst: str, src: str, bias: bool = True) -> NameMap:
    """``dst.weight`` (and ``dst.bias``) from ``src``'s, as they are."""
    out = {f"{dst}.weight": same(f"{src}.weight")}
    if bias:
        out[f"{dst}.bias"] = same(f"{src}.bias")
    return out


def flat(key: str, unit_axes: int) -> Entry:
    """A bare parameter stored with ``unit_axes`` leading unit axes
    (``ignore_token`` ``[1, 1, 1, C]``, ``soi_token`` ``[1, 1, C]``)."""
    return Entry((key,), lambda x: x.reshape(-1),
                 lambda shape: (1,) * unit_axes + tuple(shape))


def _linear(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, 0, 0] if x.ndim == 4 else x


def linear_of(key: str) -> Entry:
    """A Linear stored as a Linear (SD2.x ``proj_in``/``proj_out``) or as a
    1x1 Conv (SD1.x)."""
    return Entry((key,), _linear)


def const(value: Callable[[], torch.Tensor]) -> Entry:
    """A parameter no source tensor fills (the TextDecoder's new head)."""
    return Entry((), value)


def prefixed(prefix: str, nmap: NameMap) -> NameMap:
    """``nmap`` with ``prefix`` on every port name."""
    return {prefix + name: e for name, e in nmap.items()}


def source_prefixed(prefix: str, nmap: NameMap) -> NameMap:
    """``nmap`` with ``prefix`` on every source key."""
    return {name: dataclasses.replace(e, keys=tuple(prefix + k for k in e.keys))
            for name, e in nmap.items()}


def source_specs(nmap: NameMap, shapes: Mapping[str, Shape]) -> Dict[str, Shape]:
    """Each source key of ``nmap`` -> its shape in a checkpoint, given the
    port parameters' ``shapes``."""
    out: Dict[str, Shape] = {}
    for name, e in nmap.items():
        for k in e.keys:
            shape = tuple(shapes[name])
            out[k] = tuple(e.source_shape(shape) if e.source_shape else shape)
    return out


def check_coverage(nmap: NameMap, source_keys: Iterable[str],
                   targets: Mapping[str, Shape],
                   skips: Sequence[str] = (), full: bool = True) -> None:
    """Raise unless ``nmap`` fits: every entry names a parameter of
    ``targets`` and reads keys the source has, every source key is read or
    matches a ``skips`` pattern, and with ``full`` every target is
    filled."""
    unknown = sorted(n for n in nmap if n not in targets)
    if unknown:
        raise KeyError(f"{len(unknown)} converted names the model lacks: "
                       f"{unknown[:8]}")
    if full:
        unfilled = sorted(n for n in targets if n not in nmap)
        if unfilled:
            raise KeyError(f"{len(unfilled)} model parameters no source key "
                           f"fills: {unfilled[:8]}")
    source = set(source_keys)
    read = {k for e in nmap.values() for k in e.keys}
    absent = sorted(read - source)
    if absent:
        raise KeyError(f"{len(absent)} source keys missing: {absent[:8]}")
    pats = [re.compile(p) for p in skips]
    stray = sorted(k for k in source - read
                   if not any(p.search(k) for p in pats))
    if stray:
        raise KeyError(f"{len(stray)} source keys no entry reads: "
                       f"{stray[:8]}")


def convert_entry(e: Entry, sd: Mapping, device=None) -> torch.Tensor:
    """One entry's tensor, its sources moved to ``device`` first."""
    xs = [sd[k] if device is None else sd[k].to(device) for k in e.keys]
    return e.fn(*xs) if e.fn is not None else xs[0]


class _Staging:
    """One pinned host buffer, grown to the largest source tensor, that
    each source tensor is read into on its way to the card."""

    def __init__(self):
        self.buf = None

    def __call__(self, n: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < n:
            self.buf = None
            self.buf = torch.empty(max(n, 1), dtype=torch.uint8,
                                   pin_memory=True)
        return self.buf


@torch.no_grad()
def stream_into(params: Mapping[str, torch.Tensor], nmap: NameMap,
                sd: Mapping) -> int:
    """Fill ``params[name]`` from each entry of ``nmap`` in the parameter's
    dtype; a shape mismatch raises.  For the card, a source with
    ``read(key, alloc)`` (`state_dict_io.TorchStateDict`) reads each
    tensor into one pinned host buffer, copied to the card before the next
    read, so the host holds about one tensor.  Returns the source bytes
    read."""
    nbytes = 0
    read = getattr(sd, "read", None)
    stage = _Staging()
    for name, e in nmap.items():
        p = params[name]
        xs = []
        for k in e.keys:
            staged = p.device.type == "cuda" and read is not None
            t = read(k, stage) if staged else sd[k]
            nbytes += t.numel() * t.element_size()
            xs.append(t.to(p.device))  # from pinned memory: synchronous
        x = e.fn(*xs) if e.fn is not None else xs[0]
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"{name}: converted shape {tuple(x.shape)}, "
                             f"the model's {tuple(p.shape)}")
        p.copy_(x)
    return nbytes
