"""The port across `torch.distributed` processes on the CPU (gloo): the
prediction gather, the serving entry points under a ``mesh:`` stanza, and
the mesh refusals.

  * `Evaluator.gather_predictions` over two processes whose predictions
    have different keys and counts (JAX's tests/test_multiprocess.py);
  * `evaluate` and `inference` run as two ranks with ``mesh: {tensor: 2}``
    at the tiny preset, as torchrun runs them (``--device cpu``): rank 0
    alone writes the outputs, and they equal the one-process run's, as
    tests/test_cli_mesh.py checks the JAX entry points on a mesh;
  * a ``mesh:`` stanza over more than one device with no process group,
    and one whose size is not the world's, raise.

Every rank imports no JAX; each group of ranks is killed at its timeout
(`_torch_dist.run_ranks`).
"""

import json

import numpy as np
import pytest
import yaml
from PIL import Image

from mm_interleaved_tpu_torch import evaluate, inference
from mm_interleaved_tpu_torch.data.synthetic_eval import (
    write_eval_assets, write_inference_assets)
from mm_interleaved_tpu_torch.parallel.inference import (check_runtime,
                                                         runtime_mesh_shape)

from _torch_dist import run_ranks


def test_two_process_gather_and_mesh_refusals(tmp_path):
    """Both ranks hold the merge of both ranks' predictions, with int keys;
    a mesh of 4 or of 2 x 2 ranks in a world of 2 raises; ``tensor: 2``,
    ``fsdp: 2`` and ``data: -1`` fit it."""
    prefix = str(tmp_path / "merged")
    run_ranks(["tests/_torch_mp_worker.py", prefix], world=2, timeout=60)
    for r in range(2):
        out = json.loads(open(f"{prefix}.rank{r}.json").read())
        assert out["merged"] == {"0": "a cat", "1": "a bird", "2": "a dog"}
        assert out["keys_are_ints"]
        for name, msg in out["refused"].items():
            assert msg is not None and "the world has 2" in msg, name
        assert out["accepted"] == {"tensor_2": [1, 1, 2],
                                   "fsdp_2": [1, 2, 1],
                                   "data_rest": [2, 1, 1]}


def test_mesh_without_a_process_group_raises():
    with pytest.raises(RuntimeError, match="no process group"):
        check_runtime({"tensor": 2})
    with pytest.raises(RuntimeError, match="no process group"):
        runtime_mesh_shape({"data": 2, "fsdp": 2})
    assert runtime_mesh_shape({"data": -1}) == (1, 1, 1)
    assert runtime_mesh_shape(None) == (1, 1, 1)


def _rows(path):
    rows = [json.loads(x) for x in path.read_text().split("\n") if x]
    for r in rows:
        r.pop("time")
        r.pop("image_dir", None)
    return rows


def _pngs(root):
    return {p.relative_to(root).as_posix(): np.asarray(Image.open(p),
                                                       np.int16)
            for p in sorted(root.rglob("*.png"))}


def _same_pngs(got, want):
    assert sorted(got) == sorted(want) and got
    for k in want:
        # fp32 sums over two ranks: a pixel may round the other way
        assert np.abs(got[k] - want[k]).max() <= 1, k


def test_evaluate_entry_on_two_ranks_equals_one_process(tmp_path):
    """Captions, VQA, VisDial ranking, grounding, text to image and
    storytelling: ``eval_metrics.jsonl`` and the images of rank 0 equal
    the one-process run's; nothing else writes them."""
    stanzas = write_eval_assets(str(tmp_path / "assets"))
    cfg = dict(model=dict(preset="tiny"),
               data=dict(tokenizer_path=None, val=stanzas),
               evaluation=dict(batch_size=2, max_batches=1,
                               num_inference_steps=2))
    one = tmp_path / "one.yaml"
    one.write_text(yaml.safe_dump(dict(cfg, output_dir=str(tmp_path / "a"))))
    two = tmp_path / "two.yaml"
    two.write_text(yaml.safe_dump(dict(cfg, output_dir=str(tmp_path / "b"),
                                       mesh={"tensor": 2})))
    run_ranks(["-m", "mm_interleaved_tpu_torch.evaluate", "--config",
               str(two), "--device", "cpu"], world=2, timeout=240)
    evaluate.main(["--config", str(one), "--device", "cpu"])
    want, got = (_rows(tmp_path / d / "eval_metrics.jsonl") for d in "ab")
    assert [r["dataset"] for r in got] == [s["dataset_name"]
                                           for s in stanzas]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
            else:
                assert g[k] == v, k
    _same_pngs(_pngs(tmp_path / "b"), _pngs(tmp_path / "a"))


def test_inference_entry_on_two_ranks_equals_one_process(tmp_path):
    """Text, image, text with ``mesh: {tensor: 2}``: rank 0 writes one PNG
    and one results file, equal to the one-process run's."""
    annt = write_inference_assets(str(tmp_path / "in"))
    cfg = dict(model=dict(preset="tiny"), data=dict(tokenizer_path=None),
               inference=dict(num_iter=3, max_new_tokens=4,
                              num_inference_steps=2,
                              force_image_every_turn=True))
    one = tmp_path / "one.yaml"
    one.write_text(yaml.safe_dump(cfg))
    two = tmp_path / "two.yaml"
    two.write_text(yaml.safe_dump(dict(cfg, mesh={"tensor": 2})))
    args = ["--annt_path", annt, "--image_root", str(tmp_path / "in"),
            "--device", "cpu"]
    run_ranks(["-m", "mm_interleaved_tpu_torch.inference", "--config",
               str(two), "--output_dir", str(tmp_path / "b"), *args],
              world=2, timeout=240)
    want = inference.main(["--config", str(one), "--output_dir",
                           str(tmp_path / "a"), *args])
    got = sorted((tmp_path / "b").glob("eval_results_*.json"))
    assert len(got) == 1
    assert json.loads(got[0].read_text()) == want["results"]
    _same_pngs(_pngs(tmp_path / "b"), _pngs(tmp_path / "a"))
