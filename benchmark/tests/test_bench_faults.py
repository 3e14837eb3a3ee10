"""The rest of a run, past the look for a card, on the tiny cells on the
CPU: sound runs come out correct, and a run whose timed path alters an
answer where it is produced comes out not correct.

The faults a serving cell can have: a served token altered (the texts'
``served_rank_gap``), an image altered (``image_rms_gap``), and the
prefill's logits off (``logprob_gap``).  A step that returns its state
unchanged, half of a batch left out of a mean, and the exchange between
chips belong to training and to cells on more than one card, which this
benchmark does not have."""

import pytest

from benchmark.harness import faults, report, runner
from benchmark.tests import tiny_cells

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    tiny_cells.install(monkeypatch)


def run(cell, program=None):
    res = runner.run(cell, SEED, 0.3, False, "cpu", program=program,
                     log=lambda m: None)
    return res, report.correct(res["checks"])


@pytest.mark.parametrize("cell", ["tiny.t2i", "tiny-int8.vqa"])
def test_sound_runs_are_correct(cell):
    res, ok = run(cell)
    assert ok, res["checks"]
    assert res["requests"] == 3 * res["units"] and res["units"] >= 1


@pytest.mark.parametrize("cell, fault, number", [
    ("tiny-int8.vqa", faults.alter_token, "served_rank_gap"),
    ("tiny-int8.vqa", faults.skew_prefill, "logprob_gap"),
    ("tiny.t2i", faults.alter_image, "image_rms_gap"),
])
def test_faults_are_not_correct(cell, fault, number):
    res, ok = run(cell, faults.program(fault))
    assert not ok
    reading = {c["name"]: c for c in res["checks"]}[number]
    assert reading["value"] > reading["limit"]
