"""The port's checkpoint reader and writer (`utils/state_dict_io.py`):
round trips in F32, F16 and BF16 (and the integer dtypes) through the
port's own writer, files of either side read by the other (`safetensors`
is installed here, not on the machine with the card), torch pickles read
memory-mapped, a sharded directory that reads one tensor per lookup, and
the refusals (a truncated file, an unknown dtype, a key in two shards)."""

import json
import os
import struct

import numpy as np
import pytest
import torch

from mm_interleaved_tpu_torch.utils import state_dict_io as io


def tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.f32": torch.randn(3, 5, generator=g),
        "b.f16": torch.randn(7, generator=g).half(),
        "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
        "d.i64": torch.arange(6).reshape(2, 3),
        "e.u8": torch.arange(5, dtype=torch.uint8),
        "f.bool": torch.tensor([True, False, True]),
        "g.empty": torch.zeros(0, 4),
        "h.scalar": torch.tensor(2.5),
    }


def test_round_trip_through_the_port_writer(tmp_path):
    t = tensors()
    path = str(tmp_path / "x.safetensors")
    n = io.save_safetensors(t, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    f = io.SafetensorsFile(path)
    assert f.metadata == {"format": "pt"} and f.keys() == list(t)
    for k, v in t.items():
        got = f.get(k)
        assert got.dtype == v.dtype and got.shape == v.shape, k
        assert torch.equal(got, v), k
        assert f.shape(k) == tuple(v.shape)


def test_files_cross_between_the_port_and_safetensors(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as pt_load, save_file

    t = tensors(1)
    ours = str(tmp_path / "ours.safetensors")
    io.save_safetensors(t, ours)
    read = pt_load(ours)
    assert all(torch.equal(read[k], v) for k, v in t.items())
    numpy_read = np_load(ours)  # numpy has no bf16: F32 and F16 by numpy
    for k in ("a.f32", "b.f16", "d.i64"):
        np.testing.assert_array_equal(numpy_read[k], t[k].numpy())
    theirs = str(tmp_path / "theirs.safetensors")
    save_file(t, theirs)
    sd = io.load_torch_state_dict(theirs)
    assert set(sd) == set(t)
    assert all(torch.equal(sd[k], v) for k, v in t.items())


def test_torch_pickles_are_read_mapped(tmp_path):
    t = {k: v for k, v in tensors(2).items() if k != "g.empty"}
    torch.save({"state_dict": t, "epoch": 3}, tmp_path / "m.pth")
    sd = io.load_torch_state_dict(str(tmp_path / "m.pth"))
    assert set(sd) == set(t)
    assert all(torch.equal(sd[k], v) for k, v in t.items())
    buf = torch.zeros(64, dtype=torch.uint8)
    assert torch.equal(sd.read("a.f32", lambda n: buf), t["a.f32"])


def test_a_sharded_directory_stays_lazy(tmp_path, monkeypatch):
    """The headers give the keys and shapes; a lookup reads one tensor;
    the safetensors shards win over a pickle beside them (HF's choice)."""
    t = tensors(3)
    specs = [(k, tuple(v.shape), v.dtype) for k, v in t.items()]
    files = io.write_sharded(str(tmp_path), specs, t.__getitem__, shards=3)
    assert len(files) == 3
    index = json.loads((tmp_path / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(t)
    torch.save({"x": torch.zeros(1)}, tmp_path / "pytorch_model.bin")
    reads = []
    get = io.SafetensorsFile.get
    monkeypatch.setattr(io.SafetensorsFile, "get",
                        lambda self, k, alloc=None: reads.append(k)
                        or get(self, k, alloc))
    sd = io.load_torch_state_dict(str(tmp_path))
    assert set(sd) == set(t) and len(sd) == len(t)
    assert sd.shape("c.bf16") == (2, 3, 4) and reads == []
    assert torch.equal(sd["c.bf16"], t["c.bf16"]) and reads == ["c.bf16"]
    view = io.PrefixView(sd, "c.")
    assert list(view) == ["bf16"] and view.shape("bf16") == (2, 3, 4)
    assert reads == ["c.bf16"]
    # a read into a buffer the caller gives (the converter's pinned one)
    buf = torch.zeros(64, dtype=torch.uint8)
    got = sd.read("c.bf16", lambda n: buf)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(got, t["c.bf16"])


def test_strip_prefix_and_pad_rows():
    sd = {"model.x": torch.ones(1), "model.y": torch.zeros(1)}
    view = io.strip_prefix(sd)
    assert sorted(view) == ["x", "y"] and torch.equal(view["x"], sd["model.x"])
    assert io.strip_prefix({"model.x": 1, "y": 2}) == {"model.x": 1, "y": 2}
    w = torch.randn(5, 3).half()
    out = io.pad_rows(w, 8)
    assert out.dtype == torch.float32 and out.shape == (8, 3)
    assert torch.equal(out[:5], w.float())
    assert torch.allclose(out[5:], w.float().mean(0).expand(3, -1))
    assert torch.equal(io.pad_rows(w, 4), w[:4])


def test_bad_files_raise(tmp_path):
    path = str(tmp_path / "x.safetensors")
    io.save_safetensors({"a": torch.ones(4)}, path)
    raw = open(path, "rb").read()
    (tmp_path / "cut.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="does not fit"):
        io.SafetensorsFile(str(tmp_path / "cut.safetensors"))
    header = json.dumps({"a": {"dtype": "F4", "shape": [1],
                               "data_offsets": [0, 1]}}).encode()
    (tmp_path / "odd.safetensors").write_bytes(
        struct.pack("<Q", len(header)) + header + b"\0")
    with pytest.raises(ValueError, match="dtype"):
        io.SafetensorsFile(str(tmp_path / "odd.safetensors"))
    (tmp_path / "short.safetensors").write_bytes(b"\1\2")
    with pytest.raises(ValueError, match="header"):
        io.SafetensorsFile(str(tmp_path / "short.safetensors"))
    d = tmp_path / "dup"
    d.mkdir()
    for name in ("a", "b"):
        io.save_safetensors({"w": torch.ones(1)}, str(d / f"{name}.safetensors"))
    with pytest.raises(ValueError, match="more than one file"):
        io.load_torch_state_dict(str(d))
    with pytest.raises(FileNotFoundError):
        io.load_torch_state_dict(str(tmp_path / "missing"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint files"):
        io.load_torch_state_dict(str(tmp_path / "empty"))
