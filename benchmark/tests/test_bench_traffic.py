"""The traffic generator: the same seed gives the same inputs, every unit
of every seed holds the same request sizes, and each mix makes the
requests its cell promises."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.traffic import Traffic, mix_seed

BIG_SEED = 2 ** 33 + 12345


def traffic(name, seed=BIG_SEED):
    cfg = spec.config_spec(
        "mmi13b" if name == "t2i-b24" else "mmi13b-int8")["model"]
    return Traffic(spec.traffic_spec(name), cfg, seed, "cpu")


def sizes(t, unit):
    return sorted(unit["attention_mask"].sum(dim=1).tolist())


@pytest.mark.parametrize("mix", ["t2i-b24", "vqa8shot-b12"])
def test_same_seed_same_inputs(mix):
    a, b = traffic(mix).unit(3), traffic(mix).unit(3)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mix", ["t2i-b24", "vqa8shot-b12"])
def test_seeds_and_units_change_order_not_sizes(mix):
    t1, t2 = traffic(mix), traffic(mix, seed=7)
    u = [t1.unit(0), t1.unit(1), t2.unit(0)]
    assert not torch.equal(u[0]["text_ids"], u[1]["text_ids"])
    assert not torch.equal(u[0]["text_ids"], u[2]["text_ids"])
    assert sizes(t1, u[0]) == sizes(t1, u[1]) == sizes(t2, u[2])
    assert u[0]["text_ids"].shape == u[1]["text_ids"].shape \
        == u[2]["text_ids"].shape
    assert sorted(u[0]["num_image_per_seq"].tolist()) \
        == sorted(u[2]["num_image_per_seq"].tolist())


def test_t2i_requests():
    t = traffic("t2i-b24")
    sp = spec.config_spec("mmi13b")["model"]["special"]
    u = t.unit(0)
    ids, att, n = u["text_ids"], u["attention_mask"], u["num_image_per_seq"]
    assert ids.shape[0] == 24 and u["image_tensors"].shape[:2] == (24, 3)
    assert set(n.tolist()) == {2, 3}  # 1-2 context images and the target
    for b in range(24):
        row = ids[b, :int(att[b].sum())]
        assert row[0] == sp["bos_token_id"]
        # the row ends in the target's <soi> and its 64 placeholders
        assert row[-65] == sp["soi_token_id"]
        assert (row[-64:] == sp["image_token_id"]).all()
        assert int((row == sp["soi_token_id"]).sum()) == int(n[b])
        text = row[(row != sp["soi_token_id"])
                   & (row != sp["image_token_id"])][1:]
        assert 24 <= len(text) <= 128
        assert ((text >= 10) & (text < 30000)).all()
    # right padding; the empty image slots hold zeros
    assert (att[:, 0] == 1).all()
    for b in range(24):
        assert (u["image_tensors"][b, int(n[b]):] == 0).all()
    rows = u["target_rows"].tolist()
    assert rows == [b * 3 + int(n[b]) - 1 for b in range(24)]


def test_vqa_requests():
    t = traffic("vqa8shot-b12")
    sp = spec.config_spec("mmi13b-int8")["model"]["special"]
    u = t.unit(5)
    ids, att = u["text_ids"], u["attention_mask"]
    assert ids.shape[0] == 12 and u["image_tensors"].shape[:2] == (12, 9)
    assert (u["num_image_per_seq"] == 9).all()
    lens = att.sum(dim=1)
    assert 700 <= int(lens.min()) and int(lens.max()) <= 900
    assert (att[:, -1] == 1).all()  # left padding
    for b in range(12):
        row = ids[b, -int(lens[b]):]
        assert int((row == sp["soi_token_id"]).sum()) == 9
        assert row[-1] not in (sp["soi_token_id"], sp["image_token_id"])


def test_pixels_from_the_seed():
    a = traffic("t2i-b24").unit(0)["image_tensors"]
    b = traffic("t2i-b24", seed=BIG_SEED + 1).unit(0)["image_tensors"]
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    assert not torch.equal(a, b)


def test_mix_seed_takes_large_seeds():
    s = {mix_seed(BIG_SEED + k, "unit", 0) for k in range(50)}
    assert len(s) == 50 and all(0 <= x < 2 ** 62 for x in s)
    np.random.RandomState(mix_seed(2 ** 40, "u", 1) % (1 << 32))
