"""The plain reference against the port at the tiny preset on the CPU,
from the benchmark's weights: the same bits in, the same answers out."""

import pytest
import torch

from benchmark.harness import check, models, runner
from benchmark.harness.traffic import Traffic
from benchmark.harness.weights import group_key, make_group
from benchmark.tests import tiny_cells

SEED = 2 ** 35 + 17


@pytest.fixture(scope="module", params=[None, "int8"])
def sides(request):
    spec = tiny_cells.tiny_config(request.param)
    gen = models.program(spec, SEED, "cpu")
    ref = models.reference(spec, SEED, "cpu")
    return spec, gen, ref


def test_same_weights(sides):
    spec, gen, ref = sides
    rp = dict(ref.named_parameters())
    n_int8 = 0
    for name, p in gen.model.named_parameters():
        if p.dtype == torch.int8:  # a projection's codes: dequantized
            m = gen.model.get_submodule(name.rsplit(".", 1)[0])
            deq = m.weight.float() * m.scale[:, None]
            assert torch.allclose(deq, rp[name], rtol=0, atol=1e-7), name
            n_int8 += 1
        elif name.endswith(".scale"):
            assert spec["quantize"] == "int8"
        else:
            assert torch.equal(p.float(), rp[name]), name
    assert (n_int8 > 0) == (spec["quantize"] == "int8")


def test_weights_come_from_the_seed_and_the_name():
    a = make_group(1, "x.0", [("x.0.w", (4, 3)), ("x.0.bias", (4,))],
                   "cpu", torch.bfloat16)
    b = make_group(1, "x.0", [("x.0.w", (4, 3)), ("x.0.bias", (4,))],
                   "cpu", torch.bfloat16)
    c = make_group(2, "x.0", [("x.0.w", (4, 3)), ("x.0.bias", (4,))],
                   "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x.0.w"], c["x.0.w"])
    assert group_key("mm_decoder.layers.7.self_attn.q_proj.weight") \
        == "mm_decoder.layers.7"
    assert group_key("soi_token") == "soi_token"


def test_texts(sides):
    spec, gen, ref = sides
    mix = dict(tiny_cells.TINY_VQA)
    tr = Traffic(mix, spec["model"], SEED, "cpu")
    u = tr.unit(0)
    cfg = runner._text_config(mix)
    cap = check.Capture(gen.model)
    cap.start(0)
    got = gen.generate_texts(u["text_ids"], u["image_tensors"],
                             u["num_image_per_seq"], u["attention_mask"],
                             cfg=cfg)
    cap.stop()
    cap.remove()
    from benchmark.reference.generation.text import (
        TextGenerationConfig, generate_texts)

    want = generate_texts(ref, u["text_ids"], u["image_tensors"],
                          u["num_image_per_seq"], u["attention_mask"],
                          TextGenerationConfig(num_beams=3, max_new_tokens=5,
                                               length_penalty=0.0))
    assert torch.equal(got, want)
    lp = check.reference_logprobs(ref, u, got)
    gaps = check.text_gaps(lp, got, cap.units[0], 3, cfg.eos_token_ids)
    assert gaps["logprob_gap"] < 1e-4
    assert gaps["served_rank_gap"] < 1e-4


def test_images():
    spec = tiny_cells.tiny_config()
    gen = models.program(spec, SEED, "cpu")
    ref = models.reference(spec, SEED, "cpu")
    tr = Traffic(tiny_cells.TINY_T2I, spec["model"], SEED, "cpu")
    got = runner.run_unit(gen, tr, 2)
    want = check.reference_images(ref, tr, 2, [0, 2])
    assert check.image_gap(got[[0, 2]], want) < 1e-5
