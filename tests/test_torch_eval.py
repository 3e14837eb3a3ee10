"""The evaluation slice of the PyTorch port against the JAX package's, on
the tiny preset without image decoder (every param leaf noised), with
the synthetic eval files of `data.synthetic_eval` written into a temporary
directory:

  * the copies: the metrics equal JAX's on seeded random strings, boxes and
    scores; the datasets and collators yield JAX's batches bit for bit;
    `resolve_eval_config` equals JAX's for every mode;
  * the routes: the caption (beam 5), VQA (beam 3) and grounding (greedy)
    predictions equal JAX's `Evaluator`'s on the same batches, the ranking
    route's NDCG within 1e-6;
  * the entry points on the CPU: `evaluate` appends one row per route,
    `inference` writes a PNG and its JSON; the `Trainer.fit` eval hook;
    `load_model` over a `Trainer` checkpoint;
  * the refusals: a mesh, an unknown ``quantize`` mode, an orbax
    checkpoint and ``--device cuda`` without a GPU each raise.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from mm_interleaved_tpu.data.datasets import (
    ImageTextJsonlDataset as JJsonl,
    VizWizVQADataset as JVizWiz,
    iterate_dataset as j_iterate,
)
from mm_interleaved_tpu.engine.evaluator import (
    EvalConfig as JEvalConfig,
    Evaluator as JEvaluator,
)
from mm_interleaved_tpu.data.transforms import create_transform as j_transform
from mm_interleaved_tpu.utils import metrics as JM
import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch import evaluate, inference
from mm_interleaved_tpu_torch.data.datasets import (
    ImageTextJsonlDataset,
    VizWizVQADataset,
    iterate_dataset,
)
from mm_interleaved_tpu_torch.data.synthetic_eval import (
    write_eval_assets,
    write_images,
    write_inference_assets,
)
from mm_interleaved_tpu_torch.data.transforms import create_transform
from mm_interleaved_tpu_torch.engine.evaluator import EvalConfig, Evaluator
from mm_interleaved_tpu_torch.engine.optim import OptimConfig
from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.parallel.inference import (
    build_generation_runtime,
)
from mm_interleaved_tpu_torch.utils import metrics as M
from mm_interleaved_tpu_torch.utils.checkpoint import load_model

from _torch_eval_parity import RecordingJax, jax_entry, tiny_pair, tokenizers

J_EVALUATE = jax_entry("evaluate")


@pytest.fixture(scope="module")
def pair():
    jcfg, jmodel, params, model = tiny_pair(with_image_decoder=False)
    jtok, ptok = tokenizers(jcfg, model.cfg)
    return jcfg, jmodel, params, model, jtok, ptok


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    return str(root), write_eval_assets(str(root))


def _stanza(assets, name):
    return next(s for s in assets[1] if s["dataset_name"] == name)


def _batches(ds_cfg, model_cfg, tok, evaluate_mod, batch_size=2):
    ds, coll, mode = evaluate_mod.build_eval_dataset(ds_cfg, model_cfg, tok)
    it = (j_iterate if evaluate_mod is J_EVALUATE else iterate_dataset)
    return ds, mode, list(it(ds, batch_size, coll))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


# -------------------------------------------------------------------- #
# the copies


def _random_texts(rs, n, words=("a", "dog", "cat", "runs", "on", "the",
                                "grass", "red", "Two", "people.", "2",
                                "yes", "no", "an", "apple,")):
    return [" ".join(rs.choice(words, rs.randint(1, 9))) for _ in range(n)]


def test_metrics_copy_equals_jax():
    """Every metric of the copy gives JAX's value exactly on seeded random
    captions, answers, boxes, scores and label maps."""
    rs = np.random.RandomState(0)
    cands = _random_texts(rs, 12)
    refs = [_random_texts(rs, rs.randint(1, 4)) for _ in range(12)]
    for name in ("cider_d", "bleu", "rouge_l", "meteor"):
        assert getattr(M, name)(cands, refs) == \
            getattr(JM, name)(cands, refs), name
    for c, r in zip(cands, refs):
        ans = M.extract_vqa_answer(c)
        assert ans == JM.extract_vqa_answer(c)
        assert M.normalize_vqa_answer(c) == JM.normalize_vqa_answer(c)
        assert M.vqa_accuracy(ans, r * 4) == JM.vqa_accuracy(ans, r * 4)
    scores, rel = rs.randn(5, 7), rs.rand(5, 7).round(1)
    assert M.ndcg(scores, rel) == JM.ndcg(scores, rel)
    np.testing.assert_array_equal(M.scores_to_ranks(scores),
                                  JM.scores_to_ranks(scores))
    boxes = [sorted(rs.rand(2)) + sorted(rs.rand(2)) for _ in range(8)]
    boxes = [[b[0], b[2], b[1], b[3]] for b in boxes]
    gts = boxes[::-1]
    assert M.grounding_accuracy(boxes, gts) == \
        JM.grounding_accuracy(boxes, gts)
    for a, b in zip(boxes, gts):
        assert M.box_iou(a, b) == JM.box_iou(a, b)
    s = "<box>(0.1,0.2)(0.5,0.7)</box> and <box>(10,20)(300,400)</box>"
    assert M.parse_box_string(s) == JM.parse_box_string(s)
    preds = [rs.randint(0, 5, (6, 7)) for _ in range(3)]
    labels = [rs.randint(0, 5, (6, 7)) for _ in range(3)]
    assert M.miou_from_maps(preds, labels, 4) == \
        JM.miou_from_maps(preds, labels, 4)


# the examples of the Porter paper, NLTK's irregular forms and y runs
PORTER_WORDS = (
    "caresses ponies ties caress cats feed agreed plastered bled motoring "
    "sing conflated troubled sized hopping tanned falling hissing fizzed "
    "failing filing happy sky relational conditional rational valenci "
    "hesitanci digitizer conformabli radicalli differentli vileli "
    "analogousli vietnamization predication operator feudalism "
    "decisiveness hopefulness callousness formaliti sensitiviti "
    "sensibiliti triplicate formative formalize electriciti electrical "
    "hopeful goodness revival allowance inference airliner gyroscopic "
    "adjustable defensible irritant replacement adjustment dependent "
    "adoption homologou communism activate angulariti homologous effective "
    "bowdlerize probate rate cease controll roll dying lying skies innings "
    "outings cannings howe proceed exceed succeed news yyy y ay syzygy toy "
    "spied tied died flies enjoy biology fully hopefulli generously").split()
SUFFIXES = ("", "s", "es", "ies", "ed", "ied", "eed", "ing", "ly", "y",
            "ness", "ful", "fulli", "ation", "ational", "ization", "alli",
            "ement", "ment", "ion", "ive", "ize", "ical", "logi", "bli",
            "ll", "e")


def test_porter_stemmer_equals_nltk():
    """The port's stemmer (the card's machine has no nltk) gives nltk's
    default `PorterStemmer` stem for every word of the repository's
    documents and code, the paper's examples and each of 40 stems with 27
    suffixes."""
    import re

    from nltk.stem.porter import PorterStemmer

    from mm_interleaved_tpu_torch.utils import porter

    words = set(PORTER_WORDS)
    for name in ("README.md", "SURVEY.md", "PAPER.md", "ROADMAP.md",
                 "evaluate.py", "chip_smoke.py"):
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), name)
        with open(path, errors="ignore") as f:
            words.update(re.findall(r"[A-Za-z]+", f.read()))
    words.update(stem + suf for stem in PORTER_WORDS[:40] for suf in SUFFIXES)
    ps = PorterStemmer()
    bad = [(w, ps.stem(w), porter.stem(w)) for w in sorted(words)
           if ps.stem(w) != porter.stem(w)]
    assert len(words) > 3000 and not bad, bad[:10]


def test_datasets_copy_yields_jax_batches(pair, assets):
    """Each of the six routes' dataset and collator, built by the port's
    `build_eval_dataset` and the JAX entry's, gives the same batches bit
    for bit, and the same references."""
    jcfg, _, _, model, jtok, ptok = pair
    for ds_cfg in assets[1]:
        jds, jmode, want = _batches(ds_cfg, jcfg, jtok, J_EVALUATE)
        pds, pmode, got = _batches(ds_cfg, model.cfg, ptok, evaluate)
        assert pmode == jmode
        _assert_batches_equal(got, want)
        if hasattr(jds, "references"):
            assert pds.references() == jds.references()


def test_jsonl_and_vizwiz_datasets_equal_jax(tmp_path):
    """The two dataset types the six routes do not use."""
    write_images(str(tmp_path), ["a.jpg", "VizWiz_val_00000007.jpg"])
    jl = tmp_path / "pairs.jsonl"
    jl.write_text(json.dumps({"image": "a.jpg", "caption": "a cat"}) + "\n")
    vw = tmp_path / "vizwiz.json"
    vw.write_text(json.dumps([{
        "image": "VizWiz_val_00000007.jpg", "question": "what is it?",
        "answers": [{"answer": "cat"}] * 10}]))
    root = str(tmp_path)
    for jcls, pcls, args in (
            (JJsonl, ImageTextJsonlDataset, (str(jl), root)),
            (JVizWiz, VizWizVQADataset, (str(vw), root))):
        jds = jcls(*args, j_transform("numpy", 56))
        pds = pcls(*args, create_transform("numpy", 56))
        assert pds.items == jds.items and len(pds) == len(jds) == 1
        for g, w in zip(pds[0], jds[0]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mode", [
    "generate_texts", "generate_vqa", "generate_images", "generate_scores",
    "generate_grounding", "generate_storytelling"])
def test_resolve_eval_config_equals_jax(mode):
    """The reference task defaults, the explicit global keys and the
    stanza's ``generation_kwargs`` (aliases included) resolve as in JAX;
    an unknown key raises on both sides."""
    for ds_cfg, explicit in (
            ({}, set()),
            ({"generation_kwargs": {"max_length": 7, "min_length": 3,
                                    "num_validation_images": 2}},
             {"num_beams", "num_inference_steps"}),
            ({"generation_kwargs": {"repetition_penalty": 1.2}},
             {"length_penalty"})):
        want = J_EVALUATE.resolve_eval_config(
            JEvalConfig(batch_size=3, num_beams=2), mode, ds_cfg, explicit)
        got = evaluate.resolve_eval_config(
            EvalConfig(batch_size=3, num_beams=2), mode, ds_cfg, explicit)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    bad = {"generation_kwargs": {"beams": 3}}
    with pytest.raises(ValueError, match="unknown generation_kwargs"):
        J_EVALUATE.resolve_eval_config(JEvalConfig(), mode, bad)
    with pytest.raises(ValueError, match="unknown generation_kwargs"):
        evaluate.resolve_eval_config(EvalConfig(), mode, bad)


# -------------------------------------------------------------------- #
# the routes


def _evaluators(pair, out_dir, mode, ds_cfg, jit=True):
    """The JAX and the port's evaluators; ``jit``: the JAX runtime's
    entry points jitted whole (its scores path cannot be: it converts to
    numpy inside)."""
    jcfg, jmodel, params, model, jtok, ptok = pair
    base = dict(batch_size=2, max_new_tokens=6, min_new_tokens=2)
    jev = JEvaluator(jmodel, params, jtok, J_EVALUATE.resolve_eval_config(
        JEvalConfig(output_dir=str(out_dir / "jax"), **base), mode, ds_cfg,
        set(base)), runtime=RecordingJax(jmodel, params) if jit else None)
    pev = Evaluator(model, ptok, evaluate.resolve_eval_config(
        EvalConfig(output_dir=str(out_dir / "port"), **base), mode, ds_cfg,
        set(base)))
    return jev, pev


def _record_decodes(ev):
    seen = []
    decode = ev._decode_batch

    def recording(batch, gen_cfg):
        out = decode(batch, gen_cfg)
        seen.append((gen_cfg.num_beams, gen_cfg.max_new_tokens, out))
        return out

    ev._decode_batch = recording
    return seen


@pytest.mark.parametrize("name,route", [
    ("synthetic_caption", "evaluate_caption"),
    ("synthetic_vqa", "evaluate_vqa"),
    ("synthetic_grounding", "evaluate_grounding")])
def test_text_routes_predict_jax_strings(pair, assets, tmp_path, name,
                                         route):
    """The decoded strings of each batch equal the JAX `Evaluator`'s on the
    same batches (caption: 5 beams, VQA: 3, grounding: greedy over 24
    tokens), and so do the metric rows."""
    jcfg, _, _, model, jtok, _ = pair
    ds_cfg = _stanza(assets, name)
    ds, mode, batches = _batches(ds_cfg, jcfg, jtok, J_EVALUATE)
    jev, pev = _evaluators(pair, tmp_path, mode, ds_cfg)
    want_seen, got_seen = _record_decodes(jev), _record_decodes(pev)
    args = (ds.references(),) if route == "evaluate_caption" else ()
    want = getattr(jev, route)(iter(batches), *args, dataset_name=name)
    got = getattr(pev, route)(iter(batches), *args, dataset_name=name)
    assert got_seen == want_seen
    assert want_seen[0][0] == {"evaluate_caption": 5, "evaluate_vqa": 3,
                               "evaluate_grounding": 1}[route]
    assert got == want
    rows = [json.loads(x) for x in
            (tmp_path / "port" / "eval_metrics.jsonl").read_text().split(
                "\n") if x]
    assert [r["dataset"] for r in rows] == [name]


def test_ranking_route_ndcg_matches_jax(pair, assets, tmp_path):
    """VisDial option scores through `generate_scores`: NDCG within 1e-6."""
    jcfg, _, _, _, jtok, _ = pair
    ds_cfg = _stanza(assets, "synthetic_visdial")
    _, mode, batches = _batches(ds_cfg, jcfg, jtok, J_EVALUATE)
    assert batches[0]["options_ids"].shape[1] == 4
    jev, pev = _evaluators(pair, tmp_path, mode, ds_cfg, jit=False)
    want = jev.evaluate_ranking(iter(batches), "visdial")
    got = pev.evaluate_ranking(iter(batches), "visdial")
    assert got["num_samples"] == want["num_samples"] == 2
    assert abs(got["ndcg"] - want["ndcg"]) <= 1e-6


# -------------------------------------------------------------------- #
# the entry points and the trainer hook


def test_evaluate_entry_appends_one_row_per_route(assets, tmp_path):
    """`evaluate.main --device cpu` on the six synthetic routes at the tiny
    preset: one finite row each in ``eval_metrics.jsonl``."""
    cfg = dict(output_dir=str(tmp_path / "out"), model=dict(preset="tiny"),
               data=dict(tokenizer_path=None, val=assets[1]),
               evaluation=dict(batch_size=2, max_batches=1,
                               num_inference_steps=2, clip_fid=True))
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    res = evaluate.main(["--config", str(path), "--device", "cpu"])
    rows = [json.loads(x) for x in
            (tmp_path / "out" / "eval_metrics.jsonl").read_text().split("\n")
            if x]
    names = [s["dataset_name"] for s in assets[1]]
    assert [r["dataset"] for r in rows] == names == list(res)
    for r in rows:
        nums = [v for k, v in r.items() if isinstance(v, float)]
        assert nums and all(np.isfinite(nums)), r
    assert "fid" in res["synthetic_t2i"] and "clip_sim_i2i" in \
        res["synthetic_story"]


def test_inference_entry_writes_png_and_json(tmp_path):
    """`inference.main --device cpu`: a text, image, text run (forced
    image) writes one PNG at the decoder's size and the results JSON."""
    annt = write_inference_assets(str(tmp_path / "in"))
    cfg = dict(model=dict(preset="tiny"), data=dict(tokenizer_path=None),
               inference=dict(num_iter=3, max_new_tokens=4,
                              num_inference_steps=2,
                              force_image_every_turn=True))
    path = tmp_path / "inf.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = inference.main(["--config", str(path), "--annt_path", annt,
                          "--image_root", str(tmp_path / "in"),
                          "--output_dir", str(tmp_path / "out"),
                          "--device", "cpu"])
    from PIL import Image

    assert len(out["images"]) == 1
    size = tcfg.tiny_config().image_decoder.image_size
    assert Image.open(out["images"][0]).size == (size, size)
    results = json.loads(open(out["results_file"]).read())
    assert results == [{"sample": 0, "texts": results[0]["texts"],
                        "num_images": 1}]
    assert len(results[0]["texts"]) == 2


def test_fit_runs_the_eval_hook_every_n_steps(pair):
    """`Trainer.fit(eval_fn=, eval_every=2)` over 4 steps evaluates after
    steps 2 and 4 and logs the results as ``eval/<name>``."""
    from _torch_parity import tiny_batch

    cfg = tcfg.tiny_config(with_image_decoder=False)
    model = build_model(cfg, "cpu", torch.float32,
                        optim=OptimConfig(warmup_steps=0))
    trainer = Trainer(model, TrainerConfig(
        optim=OptimConfig(warmup_steps=0), log_every=100), "cpu")
    batch = tiny_batch(cfg)
    calls, logged = [], []

    def eval_fn(tr):
        calls.append(tr.step)
        return {"score": float(tr.step)}

    trainer.fit(iter([dict(batch)] * 4), num_steps=4,
                log_fn=lambda s, m: logged.append((s, m)),
                eval_fn=eval_fn, eval_every=2)
    assert calls == [2, 4]
    assert [(s, m) for s, m in logged if "eval/score" in m] == \
        [(2, {"eval/score": 2.0}), (4, {"eval/score": 4.0})]


def test_load_model_reads_a_trainer_checkpoint(tmp_path):
    """`load_model` rebuilds the frozen leaves from the checkpoint's seed
    and loads its trainable masters over them."""
    cfg = tcfg.tiny_config(with_image_decoder=False)
    optim = OptimConfig(warmup_steps=0)
    model = build_model(cfg, "cpu", torch.float32, seed=5, optim=optim)
    trainer = Trainer(model, TrainerConfig(
        optim=optim, seed=5, checkpoint_dir=str(tmp_path)), "cpu")
    with torch.no_grad():
        for x in trainer.optimizer.masters:
            x.add_(1.0)
    path = trainer.maybe_save(force=True)
    loaded = load_model(cfg, "cpu", str(path))
    seeded = build_model(cfg, "cpu", torch.float32, seed=5)
    params = dict(loaded.named_parameters())
    masters = dict(zip(trainer.optimizer.names, trainer.optimizer.masters))
    for n, p in seeded.named_parameters():
        want = masters[n] if n in masters else p
        assert torch.equal(params[n], want), n
    assert masters and not loaded.training


# -------------------------------------------------------------------- #
# the refusals


def test_refusals_raise_and_name_the_roadmap_item(assets, tmp_path):
    """Nothing falls back: a mesh over more than one device with no process
    group raises (the sharded runtime needs one rank a device); an
    unknown ``quantize`` mode raises
    `ValueError`, as JAX's runtimes do; an orbax checkpoint names the
    converter; ``--device cuda`` without a GPU raises.  ``quantize: int8``
    and the CLIP rerank's directory are accepted."""
    model = build_model(tcfg.tiny_config(with_image_decoder=False), "cpu",
                        torch.float32)
    with pytest.raises(RuntimeError, match="no process group"):
        build_generation_runtime(model, {"fsdp": 2})
    with pytest.raises(ValueError, match="unknown quantize mode"):
        build_generation_runtime(model, None, quantize="fp8")
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="convert_checkpoint"):
        load_model(model.cfg, "cpu", str(tmp_path / "orbax"))
    assert Evaluator.gather_predictions({1: "a"}) == {1: "a"}

    def entry_raises(mod, config, match, *extra, errors=(
            NotImplementedError, RuntimeError)):
        path = tmp_path / "c.yaml"
        path.write_text(yaml.safe_dump(config))
        args = ["--config", str(path), *extra]
        if mod is inference:
            args += ["--annt_path", "unused.json"]
        with pytest.raises(errors, match=match):
            mod.main(args)

    base = dict(model=dict(preset="tiny"), data=dict(tokenizer_path=None,
                                                     val=[]))
    cpu = ("--device", "cpu")
    for mod, key in ((evaluate, "evaluation"), (inference, "inference")):
        entry_raises(mod, dict(base, mesh={"data": 2}), "no process group",
                     *cpu)
        entry_raises(mod, dict(base, **{key: {"quantize": "int4"}}),
                     "unknown quantize mode", *cpu, errors=ValueError)
        if not torch.cuda.is_available():
            entry_raises(mod, base, "no CUDA device")
    # the CLIP rerank's directory and int8 weights are accepted (the
    # directory is read when a t2i stanza reranks)
    path = tmp_path / "clip.yaml"
    path.write_text(yaml.safe_dump(dict(base, evaluation={
        "clip_text_path": str(tmp_path / "clip"), "quantize": "int8"})))
    assert evaluate.main(["--config", str(path), *cpu]) == {}
