"""Reading and writing torch checkpoints, one tensor at a time (counterpart
of `scripts/convert_checkpoint.py:42-154`: `_LazySafetensors`,
`load_torch_state_dict`, `_strip_prefix`, `_pad_rows`).

``.safetensors`` is read without the ``safetensors`` package (the machine
with the card has none): the 8-byte little-endian header length, the JSON
header, then each tensor's byte range read from the file when the tensor
is asked for, into a new host tensor or a buffer the caller gives (a
pinned one, for the card), so at most that tensor is in host memory.
(Not a memory map: on the card's machine the pages of a mapped file stay
counted in the process's resident set after ``madvise(MADV_DONTNEED)``,
so a mapped source read to the card stays resident as a whole.)
``.bin`` / ``.pth`` / ``.pt`` load through ``torch.load(..., mmap=True,
weights_only=True)``, which maps their storages.  A sharded directory
stays lazy: `TorchStateDict` knows every key's file and shape from the
headers and reads one tensor per lookup (at 13B the merged eager dict
alone is about 26 GB).

`write_safetensors` writes the same format, tensor by tensor from a
callable, so a checkpoint larger than host memory can be made; the tests
and the smoke make their inputs with it.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

DTYPES: Dict[str, torch.dtype] = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "U16": torch.uint16, "U32": torch.uint32, "U64": torch.uint64,
    "BOOL": torch.bool,
}
NAMES = {dt: name for name, dt in DTYPES.items()}
# the files of a checkpoint directory, by preference: safetensors shards
# when there are any (HF's own choice), else the torch pickles
WEIGHT_PATTERNS = (("*.safetensors",), ("*.bin", "*.pth", "*.pt"))


class SafetensorsFile:
    """One ``.safetensors`` file: its header parsed, its tensors mapped."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no header "
                                 "length)")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(f.fileno()).st_size
            if n > size - 8:
                raise ValueError(f"{path}: header of {n} bytes in a file of "
                                 f"{size}")
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for key, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {key} has dtype {e['dtype']!r}, "
                                 f"not one of {sorted(DTYPES)}")
            dt = DTYPES[e["dtype"]]
            shape = tuple(int(s) for s in e["shape"])
            start, end = (int(x) for x in e["data_offsets"])
            numel = 1
            for s in shape:
                numel *= s
            if end - start != numel * dt.itemsize or start < 0 \
                    or self._base + end > size:
                raise ValueError(f"{path}: {key} {e['dtype']}{list(shape)} "
                                 f"at bytes [{start}, {end}) does not fit")
            self._entries[key] = (dt, shape, start, numel)

    def keys(self) -> List[str]:
        return list(self._entries)

    def shape(self, key: str) -> Tuple[int, ...]:
        return self._entries[key][1]

    def get(self, key: str, alloc: Callable[[int], torch.Tensor] = None
            ) -> torch.Tensor:
        """``key``'s tensor, read from the file into ``alloc(nbytes)`` (a
        uint8 host tensor of at least that many bytes; a new one by
        default)."""
        dt, shape, start, numel = self._entries[key]
        n = numel * dt.itemsize
        buf = (alloc or _new_bytes)(n)[:n]
        if n:
            with open(self.path, "rb") as f:
                f.seek(self._base + start)
                if f.readinto(memoryview(buf.numpy())) != n:
                    raise ValueError(f"{self.path}: {key} ends early")
        return buf.view(dt).view(shape)


def _new_bytes(n: int) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8)


def _torch_pickle(path: str) -> Dict[str, torch.Tensor]:
    """A ``.bin`` / ``.pth`` / ``.pt`` state dict, its storages mapped; a
    ``state_dict`` entry holding a dict is unwrapped (JAX semantics)."""
    part = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(part.get("state_dict"), dict):
        part = part["state_dict"]
    return {k: v for k, v in part.items() if isinstance(v, torch.Tensor)}


class TorchStateDict(Mapping):
    """A read-only, lazy ``{name: tensor}`` over one or more checkpoint
    files; ``shape(key)`` reads no tensor data.  A key in two files
    raises."""

    def __init__(self, files: Sequence[str]):
        self._where: Dict[str, object] = {}
        for path in files:
            src = (SafetensorsFile(path) if path.endswith(".safetensors")
                   else _torch_pickle(path))
            for key in src.keys():
                if key in self._where:
                    raise ValueError(f"{key} is in more than one file of "
                                     f"{os.path.dirname(path) or path}")
                self._where[key] = src

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.read(key)

    def read(self, key: str, alloc: Callable[[int], torch.Tensor] = None
             ) -> torch.Tensor:
        """``key``'s tensor; with ``alloc``, in ``alloc(nbytes)`` (a uint8
        host buffer), as `SafetensorsFile.get`."""
        src = self._where[key]
        if isinstance(src, SafetensorsFile):
            return src.get(key, alloc)
        t = src[key]
        if alloc is None:
            return t
        n = t.numel() * t.element_size()
        return alloc(n)[:n].view(t.dtype).view(t.shape).copy_(t)

    def shape(self, key: str) -> Tuple[int, ...]:
        src = self._where[key]
        return (src.shape(key) if isinstance(src, SafetensorsFile)
                else tuple(src[key].shape))

    def __contains__(self, key) -> bool:
        return key in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def checkpoint_files(path: str) -> List[str]:
    """The weight files of ``path``: the file itself, or a directory's
    safetensors shards, else its torch pickles (``training_args.bin``
    excluded)."""
    if not os.path.isdir(path):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return [path]
    for patterns in WEIGHT_PATTERNS:
        files = sorted(f for pat in patterns
                       for f in glob.glob(os.path.join(path, pat))
                       if "training_args" not in os.path.basename(f))
        if files:
            return files
    raise FileNotFoundError(f"no checkpoint files under {path}")


def load_torch_state_dict(path: str) -> TorchStateDict:
    """A torch checkpoint (a file, or a directory of shards) as a lazy
    state dict."""
    return TorchStateDict(checkpoint_files(path))


class PrefixView(Mapping):
    """``{key[len(prefix):]: sd[key]}`` over the keys of ``sd`` that start
    with ``prefix``, lazy (the counterpart of JAX's ``_StrippedView``)."""

    def __init__(self, sd: Mapping, prefix: str):
        self._sd = sd
        self.prefix = prefix

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._sd[self.prefix + key]

    def shape(self, key: str) -> Tuple[int, ...]:
        return self._sd.shape(self.prefix + key)

    def read(self, key: str, alloc=None) -> torch.Tensor:
        return self._sd.read(self.prefix + key, alloc)

    def __contains__(self, key) -> bool:
        return (self.prefix + key) in self._sd

    def __iter__(self) -> Iterator[str]:
        n = len(self.prefix)
        return (k[n:] for k in self._sd if k.startswith(self.prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)


def strip_prefix(sd: Mapping, prefixes: Iterable[str] = ("model.", "module.")):
    """Peel one wrapping prefix if every key carries it."""
    for p in prefixes:
        if len(sd) and all(k.startswith(p) for k in sd):
            return PrefixView(sd, p)
    return sd


def pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    """An embedding matrix cut or padded to ``rows`` rows, the padding the
    mean embedding (HF ``resize_token_embeddings`` semantics,
    mm_interleaved.py:73).  A padded matrix comes back in fp32 (fp64 for
    fp64), as the JAX converter pads the fp32 arrays it reads."""
    if w.shape[0] >= rows:
        return w[:rows]
    w = w.double() if w.dtype == torch.float64 else w.float()
    mean = w.mean(dim=0, keepdim=True)
    return torch.cat([w, mean.expand(rows - w.shape[0], -1)], dim=0)


def write_safetensors(path: str, specs: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]],
                      make: Callable[[str], torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``specs`` (``(key, shape, dtype)``) to ``path`` in the
    safetensors format, each tensor ``make(key)`` taken when its turn comes
    (only one is held at a time); returns the bytes written."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for key, shape, dt in specs:
        numel = 1
        for s in shape:
            numel *= int(s)
        size = numel * dt.itemsize
        header[key] = {"dtype": NAMES[dt], "shape": [int(s) for s in shape],
                       "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for key, shape, dt in specs:
            t = make(key)
            if tuple(t.shape) != tuple(shape) or t.dtype != dt:
                raise ValueError(f"{key}: made {t.dtype}{list(t.shape)}, "
                                 f"declared {dt}{list(shape)}")
            t = t.detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)
    return 8 + len(raw) + offset


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """``tensors`` written to one safetensors file."""
    specs = [(k, tuple(v.shape), v.dtype) for k, v in tensors.items()]
    return write_safetensors(path, specs, tensors.__getitem__, metadata)


def write_sharded(out_dir: str, specs: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]],
                  make: Callable[[str], torch.Tensor], shards: int,
                  name: str = "model") -> List[str]:
    """``specs`` over ``shards`` safetensors files of about equal bytes,
    with HF's ``<name>.safetensors.index.json`` weight map; returns the
    files."""
    os.makedirs(out_dir, exist_ok=True)
    sizes = [int(torch.Size(s).numel()) * dt.itemsize for _, s, dt in specs]
    per = -(-sum(sizes) // shards)
    groups: List[list] = [[]]
    acc = 0
    for spec, size in zip(specs, sizes):
        if acc >= per and len(groups) < shards:
            groups.append([])
            acc = 0
        groups[-1].append(spec)
        acc += size
    files, weight_map = [], {}
    for i, group in enumerate(groups):
        fname = f"{name}-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        write_safetensors(os.path.join(out_dir, fname), group, make)
        files.append(os.path.join(out_dir, fname))
        weight_map.update((k, fname) for k, _, _ in group)
    with open(os.path.join(out_dir, f"{name}.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)},
                   "weight_map": weight_map}, f)
    return files
