"""The port's sharded `Trainer` on gloo CPU processes against its one-process
`Trainer` (the JAX package's tests/test_trainer.py holds its sharded step
to the one-device one; GSPMD keeps that arithmetic, so the port's sharded
step must compute the one-process step).

The tiny preset with its image decoder in fp32, every JAX leaf seeded
noise carried over by `utils.from_flax`; both resamplers' dropout at 0.1,
so that the global draws of the dropout masks are exercised with the
image decoder's.  The batch's rows hold different numbers of valid labels
and one row has no image, so a rank-local loss normaliser would fail.  One
process a rank (`_torch_train_worker.py`, no JAX), each mesh's cases run in
one group, killed at its timeout.  This file: ``(data, fsdp, tensor)`` =
(1, 2, 1) and (1, 1, 2); `test_torch_sharded_train_mesh.py` has (2, 1, 1),
(1, 2, 2) and the entry point.  Bounds: `_torch_train_cases`.

  * one step equals the one-process step (`assert_step`); at fsdp = 2 a
    3-row batch, which ``data * fsdp`` does not divide, runs replicated
    and equals it too;
  * accumulation: ``grad_accum_steps = 2`` over two half-batches equals
    one step over the whole batch;
  * resume at an accumulation boundary repeats the uninterrupted run bit
    for bit (masters, moments, count, step and the data position);
  * the sharded checkpoint restores in one process, and a one-process
    checkpoint restores on the mesh, each then stepping as the other;
  * a non-finite loss on one rank's rows skips the update on every rank;
  * a warm start from a full checkpoint takes each rank's part of it;
  * at tensor = 2 the gradients of every leaf the plan keeps whole over
    ``tensor`` (the norms, the row layers' biases, the MMFS gate, the
    soi token, ...) are the same bits on both ranks before any sum; the
    towers' pairs are cut.
"""

import pytest
import torch

from mm_interleaved_tpu_torch.parallel.tensor import tensor_cuts
from mm_interleaved_tpu_torch.utils.checkpoint import (read_full_checkpoint,
                                                      save_full_checkpoint)

from _torch_train_worker import tiny_model
from _torch_train_cases import (DROPOUT, OPTIM, assert_bitwise,
                                assert_metrics, assert_payload, assert_step,
                                frozen_names, launch, make_draws,
                                one_process, rows, stacked, tiny_state,
                                unequal_batch)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    state = tiny_state()
    root = tmp_path_factory.mktemp("sharded_train")
    b = unequal_batch()
    halves = stacked(rows(b, (0, 1)), rows(b, (1, 0)))
    whole = rows(b, (0, 1, 1, 0))
    draws = [make_draws(2, 1), make_draws(2, 2)]
    bad = {k: v.clone() for k, v in b.items()}
    bad["image_tensors_dec"][3, 0, 0, 0, 0] = float("nan")
    job = dict(state=state, optim=OPTIM)
    cases = dict(
        step=dict(kind="step", batch=b, dropout=DROPOUT),
        odd=dict(kind="step", batch=rows(b, (0, 1, 2)), dropout=DROPOUT),
        accum=dict(kind="step", batch=halves, accum=2, draws=draws),
        whole=dict(kind="step", batch=whole, draws=[
            {k: torch.cat([d[k] for d in draws]) for k in draws[0]}]),
        guard=dict(kind="guard", batch=bad),
        resume=dict(kind="resume", accum=2, dropout=DROPOUT,
                    batch=[halves, stacked(rows(b, (2, 3)), rows(b, (3, 2)))],
                    keep=str(root / "kept" / "step_1.pt")))
    # a one-process checkpoint after one step, for the mesh to resume
    ref = {n: one_process(job, c, root / "ref" / n)
           for n, c in cases.items() if n in ("step", "odd", "resume")}
    cases["restore"] = dict(kind="restore", batch=rows(b, (2, 3, 0, 1)),
                            dropout=DROPOUT,
                            **{"from": str(root / "ref" / "resume" / "c1")})
    ref["restore"] = one_process(job, cases["restore"], root / "ref" / "r")
    # a full checkpoint of other weights (every leaf scaled), to warm-start
    warm = tiny_model(state, optim=OPTIM)
    with torch.no_grad():
        for p in warm.parameters():
            p.mul_(1.01)
    full = root / "full.pt"
    save_full_checkpoint(warm, str(full))
    cases["warm"] = dict(kind="warm", batch=b, dropout=DROPOUT,
                         **{"from": str(full)})
    ref["warm"] = one_process(job, cases["warm"], root / "ref" / "w")
    fsdp = launch(dict(job, mesh=(1, 2, 1), cases=cases), root / "fsdp", 2)
    tensor = launch(dict(job, mesh=(1, 1, 2), every_rank=["grads"], cases=dict(
        step=dict(kind="step", batch=b, dropout=DROPOUT, grads=True))),
        root / "tensor", 2)
    return dict(state=state, job=job, cases=cases, ref=ref, root=root,
                full=str(full),
                frozen=frozen_names(state), runs={(1, 2, 1): fsdp,
                                                  (1, 1, 2): tensor})


@pytest.mark.parametrize("mesh", [(1, 2, 1), (1, 1, 2)])
def test_sharded_step_equals_one_process(setup, mesh):
    assert_step(setup["runs"][mesh]["step"], setup["ref"]["step"],
                setup["state"], setup["frozen"])


def test_batch_that_the_mesh_does_not_divide_runs_replicated(setup):
    assert_step(setup["runs"][(1, 2, 1)]["odd"], setup["ref"]["odd"],
                setup["state"], setup["frozen"])


def test_grad_accumulation_equals_one_batch_sharded(setup):
    """Micro-batches (r0, r1) and (r1, r0) accumulated against the four
    rows as one batch (equal label and slot counts a micro-batch, so the
    mean losses agree), both at fsdp = 2."""
    run = setup["runs"][(1, 2, 1)]
    assert_metrics(run["accum"]["metrics"], run["whole"]["metrics"])
    assert_payload(run["accum"]["payload"], run["whole"]["payload"])


def test_resume_at_an_accumulation_boundary_is_bit_identical(setup):
    res = setup["runs"][(1, 2, 1)]["resume"]
    assert res["restored_step"] == 1
    assert res["position"] == {"epoch": 0, "offset": 1}
    assert res["resumed_metrics"] == res["metrics"][1]
    assert_bitwise(res["resumed_payload"], res["payload"])


def test_checkpoints_cross_between_mesh_and_one_process(setup, tmp_path):
    """The fsdp = 2 run's checkpoint after step 1 holds the one-process
    layout and restores in one process, whose step 2 equals the sharded
    step 2; the one-process checkpoint restores on the mesh bit for bit
    and its next step equals the one-process one."""
    run, ref = setup["runs"][(1, 2, 1)], setup["ref"]
    kept = torch.load(setup["cases"]["resume"]["keep"], weights_only=False)
    want = torch.load(ref["resume"]["checkpoint"], weights_only=False)
    assert kept["step"] == want["step"] == 1
    assert kept["data_state"] == want["data_state"]
    assert_payload(kept, want)
    (tmp_path / "c").mkdir()
    torch.save(kept, tmp_path / "c" / "step_1.pt")
    case = dict(setup["cases"]["resume"], kind="restore",
                batch=setup["cases"]["resume"]["batch"][1])
    case["from"] = str(tmp_path / "c")
    one = one_process(dict(setup["job"]), dict(case, accum=2), tmp_path / "o")
    assert one["restored_step"] == 1
    assert_bitwise(one["restored"], kept)
    assert_metrics(one["metrics"], run["resume"]["metrics"][1])
    assert_payload(one["payload"], run["resume"]["payload"])

    got = run["restore"]
    assert got["restored_step"] == 1
    assert got["position"] == {"epoch": 0, "offset": 1}
    assert_bitwise(got["restored"], want)
    assert_metrics(got["metrics"], ref["restore"]["metrics"])
    assert_payload(got["payload"], ref["restore"]["payload"])


def test_nonfinite_loss_on_one_rank_skips_every_rank(setup):
    """A NaN in row 3's image target, which rank 1 holds: the global loss
    is NaN, and no rank updates (the count stays 0, every weight as it
    was); the step counter advances."""
    g = setup["runs"][(1, 2, 1)]["guard"]
    assert g["metrics"]["loss"] != g["metrics"]["loss"]
    assert g["count"] == 0 and g["step"] == 1
    for n, x in g["weights"].items():
        assert torch.equal(x, setup["state"][n]), n


def test_tensor_ranks_agree_on_replicated_gradients(setup):
    """Megatron's f and g: every leaf that the plan keeps whole over
    ``tensor`` gets the same gradient bits on both tensor ranks; the cut
    ones (the LLM's MMFS and the towers' pairs) differ (each rank holds its
    heads)."""
    ranks = setup["runs"][(1, 1, 2)]["ranks"]
    g0, g1 = ranks[0]["step"]["grads"], ranks[1]["step"]["grads"]
    cuts = tensor_cuts(tiny_model(setup["state"], optim=OPTIM),
                       {"tensor": 2})
    cut = [n for n in g0 if n in cuts]
    assert all(g0[n].shape != setup["state"][n].shape for n in cut)
    for prefix in ("mm_decoder.", "visual_tokenizer.encoder.",
                   "visual_tokenizer.perceiver_resampler.",
                   "image_decoder.unet.", "image_decoder.perceiver"):
        assert any(n.startswith(prefix) for n in cut), prefix
    whole = [n for n in g0 if n not in cuts]
    assert any(n.startswith("image_decoder.") for n in whole)
    assert "soi_token" in whole
    for n in whole:
        assert torch.equal(g0[n], g1[n]), n
    assert any(not torch.equal(g0[n], g1[n]) for n in cut)


def test_warm_start_on_the_mesh(setup):
    """`Trainer.warm_start` at fsdp = 2 takes each rank's part of a full
    checkpoint: every weight the file's bit for bit (gathered), the masters
    the file's, then a step equal to the one-process warm-started step."""
    got, want = setup["runs"][(1, 2, 1)]["warm"], setup["ref"]["warm"]
    params = read_full_checkpoint(setup["full"])["params"]
    for n, x in got["start"]["params"].items():
        assert torch.equal(x, params[n]), n
    for n in setup["frozen"]:
        assert torch.equal(got["weights"][n], params[n]), n
    assert_metrics(got["metrics"], want["metrics"])
    assert_payload(got["payload"], want["payload"])
