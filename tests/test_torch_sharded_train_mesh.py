"""The port's sharded `Trainer` on gloo CPU processes, continued (see
tests/test_torch_sharded_train.py for the set-up and the bounds): meshes
``(data, fsdp, tensor)`` = (2, 1, 1) and (1, 2, 2), and the training entry
point under torchrun's environment.

  * one step on rows of unequal length equals the one-process step
    (`_torch_train_cases.assert_step`) on both meshes;
  * at (1, 2, 2) every leaf the plan keeps whole over ``tensor`` gets the
    same gradient bits on the two tensor ranks of each fsdp rank;
  * `train.main` as two ranks at ``--device cpu`` (``mesh: {data: -1}``,
    gloo from torchrun's environment) prints the one-process run's step
    lines (rank 0 alone) and writes the one-process run's final masters
    and moments, within the bounds.
"""

import re

import numpy as np
import pytest
import torch
import yaml

from mm_interleaved_tpu_torch import train
from mm_interleaved_tpu_torch.parallel.tensor import tensor_cuts

import _torch_train_worker as worker
from _torch_dist import run_ranks
from _torch_train_cases import (DROPOUT, OPTIM, assert_payload, assert_step,
                                frozen_names, launch, one_process, tiny_state,
                                unequal_batch)

SYNTHETIC = "configs/pretrain_synthetic.yaml"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    state = tiny_state()
    root = tmp_path_factory.mktemp("sharded_train_mesh")
    job = dict(state=state, optim=OPTIM)
    step = dict(kind="step", batch=unequal_batch(), dropout=DROPOUT)
    runs = {(2, 1, 1): launch(dict(job, mesh=(2, 1, 1), cases=dict(
        step=step)), root / "data", 2),
        (1, 2, 2): launch(dict(job, mesh=(1, 2, 2), every_rank=["grads"],
                               cases=dict(step=dict(step, grads=True))),
                          root / "both", 4)}
    return dict(state=state, runs=runs, frozen=frozen_names(state),
                ref=one_process(job, step, root / "ref"))


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 2)])
def test_sharded_step_equals_one_process_mesh(setup, mesh):
    assert_step(setup["runs"][mesh]["step"], setup["ref"], setup["state"],
                setup["frozen"])


def test_tensor_ranks_agree_at_fsdp_2(setup):
    """Ranks (f, t) = (f, 0) and (f, 1) hold the same gradient bits of
    every leaf whole over ``tensor``, before any sum over ranks."""
    ranks = setup["runs"][(1, 2, 2)]["ranks"]
    cuts = tensor_cuts(worker.tiny_model(setup["state"], optim=OPTIM),
                       {"fsdp": 2, "tensor": 2})
    assert any(n.startswith("visual_tokenizer.") for n in cuts)
    assert any(n.startswith("image_decoder.") for n in cuts)
    for f in range(2):
        g0, g1 = (ranks[2 * f + t]["step"]["grads"] for t in range(2))
        whole = [n for n in g0 if n not in cuts]
        assert "soi_token" in whole
        for n in whole:
            assert torch.equal(g0[n], g1[n]), (f, n)


def _config(tmp_path, name, **sections):
    with open(SYNTHETIC) as f:
        cfg = yaml.safe_load(f)
    for sec, kv in sections.items():
        cfg.setdefault(sec, {}).update(kv)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _step_lines(text):
    out = []
    for ln in text.splitlines():
        if ln.startswith("step "):
            step, rest = ln.split(":", 1)
            out.append((step, {k: float(v) for k, v in
                               re.findall(r"(\w+)=(\S+)", rest)
                               if k != "steps_per_sec"}))
    return out


def test_train_main_on_two_ranks_equals_one_process(tmp_path, capsys):
    """``torchrun --nproc_per_node 2 -m mm_interleaved_tpu_torch.train``
    at ``--device cpu``: rank 0 prints the one-process run's step lines
    (their 4 significant digits within 1e-3), rank 1 none, and the final
    checkpoint (rank 0's, the one-process layout) holds the one-process
    run's masters and moments within the bounds."""
    cfg = _config(tmp_path, "cfg.yaml", mesh={"data": -1, "fsdp": 1})
    args = ["--config", cfg, "--device", "cpu", "--max_steps", "3"]
    one = train.main(args + ["--output_dir", str(tmp_path / "one")])
    want = _step_lines(capsys.readouterr().out)
    outs = run_ranks(["-m", "mm_interleaved_tpu_torch.train", *args,
                      "--output_dir", str(tmp_path / "two")], world=2,
                     timeout=120)
    got = _step_lines(outs[0])
    assert [s for s, _ in got] == [s for s, _ in want] == ["step 1", "step 2",
                                                          "step 3"]
    for (_, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
    assert not _step_lines(outs[1])
    two = torch.load(tmp_path / "two" / "checkpoints" / "step_3.pt",
                     weights_only=False)
    ref = torch.load(one["checkpoint"], weights_only=False)
    assert two["step"] == ref["step"] == 3
    assert two["data_state"] == ref["data_state"]
    assert_payload(two, ref)
