"""The converter's entry point (`python -m
mm_interleaved_tpu_torch.convert_checkpoint`) in both modes on the CPU, and
its output read by every entry point: `load_model` (every weight equal to
its converted source tensor, in fp32 and bf16), ``inference --checkpoint``,
``evaluate --checkpoint`` and ``train --load_from`` (a warm start at step 0
only: the model's weights and the fp32 masters equal the file's, the
moments fresh; a resumed run does not start over from it, and it and
`load_model` of its checkpoints take the frozen weights from the file
again, refusing a file that is gone or is another)."""

import os

import numpy as np
import pytest
import torch
import yaml

from mm_interleaved_tpu_torch import (convert_checkpoint, evaluate, inference,
                                      train)
from mm_interleaved_tpu_torch.configs import tiny_config
from mm_interleaved_tpu_torch.data.synthetic_eval import (
    write_eval_assets, write_inference_assets)
from mm_interleaved_tpu_torch.engine.trainer import Trainer
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.utils import convert_ref
from mm_interleaved_tpu_torch.utils.checkpoint import (FULL_FORMAT,
                                                       load_model,
                                                       read_full_checkpoint,
                                                       save_full_checkpoint)
from mm_interleaved_tpu_torch.utils.name_map import convert_entry
from mm_interleaved_tpu_torch.utils.state_dict_io import load_torch_state_dict

from _torch_convert_assets import (ref_source, write_hf_towers,
                                   write_ref_checkpoint)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_config(with_image_decoder=True)


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """A released-format checkpoint in two bf16 shards, converted to fp32
    by the entry point: (source dir, output path, the entry's JSON)."""
    root = tmp_path_factory.mktemp("released")
    write_ref_checkpoint(str(root / "ref"), ref_source(CFG),
                         dtype=torch.bfloat16)
    out = str(root / "full.pt")
    res = convert_checkpoint.main(["--preset", "tiny", "--ref-checkpoint",
                                   str(root / "ref"), "--out", out,
                                   "--device", "cpu"])
    return str(root / "ref"), out, res


def test_released_mode_fills_every_weight(released):
    src, out, res = released
    state = read_full_checkpoint(out)
    assert state["format"] == FULL_FORMAT and state["source"] == "ref"
    assert res["converted"] == len(state["params"])
    assert res["source_bytes"] > 0 and res["stream_gb_per_s"] > 0
    sd = load_torch_state_dict(src)
    shapes = {n: tuple(p.shape) for n, p in state["params"].items()}
    nmap = convert_ref.convert_mm_interleaved(CFG, shapes.__contains__)
    for dtype in (torch.float32, torch.bfloat16):
        model = load_model(CFG, "cpu", out, dtype=dtype)
        for n, p in model.named_parameters():
            want = convert_entry(nmap[n], sd).to(dtype)
            assert p.dtype == dtype and torch.equal(p.detach(), want), n


def test_inference_and_evaluate_read_the_output(released, tmp_path):
    _, out, _ = released
    annt = write_inference_assets(str(tmp_path / "in"))
    path = tmp_path / "inf.yaml"
    path.write_text(yaml.safe_dump(dict(
        model=dict(preset="tiny"), data=dict(tokenizer_path=None),
        inference=dict(num_iter=2, max_new_tokens=4, num_inference_steps=2,
                       force_image_every_turn=True))))
    res = inference.main(["--config", str(path), "--annt_path", annt,
                          "--image_root", str(tmp_path / "in"),
                          "--output_dir", str(tmp_path / "out"),
                          "--checkpoint", out, "--device", "cpu"])
    assert len(res["images"]) == 1
    val = [s for s in write_eval_assets(str(tmp_path / "eval"))
           if s["dataset_name"] == "synthetic_vqa"]
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(dict(
        output_dir=str(tmp_path / "eval_out"), model=dict(preset="tiny"),
        data=dict(tokenizer_path=None, val=val),
        evaluation=dict(batch_size=2, max_batches=1))))
    got = evaluate.main(["--config", str(path), "--checkpoint", out,
                         "--device", "cpu"])
    assert got["synthetic_vqa"]["num_samples"] == 2


def test_tower_mode_then_warm_start(tmp_path, monkeypatch, capsys):
    """The towers fill their parts, the rest keeps the seeded init; the
    training entry starts from the file at step 0 only."""
    llm, clip, sd, _ = write_hf_towers(str(tmp_path / "towers"))
    out = str(tmp_path / "towers.pt")
    convert_checkpoint.main(["--preset", "tiny", "--llm", llm, "--clip", clip,
                             "--sd", sd, "--seed", "3", "--out", out,
                             "--device", "cpu"])
    params = read_full_checkpoint(out)["params"]
    seeded = dict(build_model(CFG, "cpu", torch.float32,
                              seed=3).named_parameters())
    hf = load_torch_state_dict(llm)
    assert torch.equal(params["mm_decoder.layers.3.mlp.up_proj.weight"],
                       hf["model.layers.3.mlp.up_proj.weight"])
    emb = params["mm_decoder.embed_tokens.weight"]
    np.testing.assert_allclose(
        emb[120:].double().numpy(),
        hf["model.embed_tokens.weight"].double().mean(0).expand(8, -1).numpy(),
        rtol=0, atol=1e-6 * emb.abs().max().item())
    for name in ("mm_decoder.layers.0.llama_cross_attn.gate",
                 "visual_tokenizer.encoder.adapter_level_embed",
                 "image_decoder.unet.mmfs_net.mid_block.conv.weight"):
        assert torch.equal(params[name], seeded[name]), name
    assert not torch.equal(params["image_decoder.unet.conv_in.weight"],
                           seeded["image_decoder.unet.conv_in.weight"])

    seen = []
    step = Trainer.train_step

    def spy(self, batch, draws=None):
        if not seen:
            opt = self.optimizer
            seen.append((opt.count, {n: x.clone() for n, x in
                                     zip(opt.names, opt.masters)},
                         {n: p.detach().clone() for n, p in
                          self.model.named_parameters()},
                         [float(m.abs().sum()) for m in opt.m]))
        return step(self, batch, draws)

    monkeypatch.setattr(Trainer, "train_step", spy)
    config = os.path.join(ROOT, "configs", "pretrain_synthetic.yaml")
    run = str(tmp_path / "run")
    argv = ["--config", config, "--output_dir", run, "--device", "cpu",
            "--load_from", out]
    train.main(argv + ["--max_steps", "3"])  # warmup 2: three steps
    assert "warm-started params from" in capsys.readouterr().out
    count, masters, weights, moments = seen[0]
    assert count == 0 and masters and not any(moments)
    for n, x in masters.items():
        assert torch.equal(x, params[n]), n
    for n, p in weights.items():
        assert torch.equal(p, params[n]), n
    seen.clear()
    res = train.main(argv + ["--max_steps", "4"])
    text = capsys.readouterr().out
    assert "resumed at step 3" in text and "warm-started" not in text
    assert seen[0][0] == 3
    # the resume and load_model of a checkpoint of the run take every frozen
    # weight from the file (not from training.seed), the trainable ones
    # from the checkpoint's masters
    frozen = {n for n, p in res["trainer"].model.named_parameters()
              if not p.requires_grad}
    assert "mm_decoder.layers.3.mlp.up_proj.weight" in frozen
    for n in frozen:
        assert torch.equal(seen[0][2][n], params[n]), n
    step3 = os.path.join(run, "checkpoints", "step_3.pt")
    masters = torch.load(step3, weights_only=False)["params"]
    model = load_model(CFG, "cpu", step3, dtype=torch.float32)
    for n, p in model.named_parameters():
        want = params[n] if n in frozen else masters[n]
        assert torch.equal(p.detach(), want), n
    # a file that is gone or is another is refused
    os.replace(out, out + ".moved")
    with pytest.raises(FileNotFoundError, match="warm-started from"):
        load_model(CFG, "cpu", step3)
    with pytest.raises(FileNotFoundError, match="warm-started from"):
        train.main(argv + ["--max_steps", "5"])
    save_full_checkpoint(model, out)
    with pytest.raises(ValueError, match="not the full checkpoint"):
        load_model(CFG, "cpu", step3)


def test_refusals(tmp_path):
    """An orbax directory, a file that is not a checkpoint, a Trainer
    checkpoint as ``--load_from`` and a mixed invocation raise."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="convert_checkpoint"):
        load_model(CFG, "cpu", str(tmp_path / "orbax"))
    (tmp_path / "x.txt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="not a checkpoint"):
        read_full_checkpoint(str(tmp_path / "x.txt"))
    torch.save({"params": {}, "opt_state": {}, "step": 1},
               tmp_path / "step_1.pt")
    with pytest.raises(ValueError, match="not a full checkpoint"):
        read_full_checkpoint(str(tmp_path / "step_1.pt"))
    with pytest.raises(ValueError, match="two modes"):
        convert_checkpoint.main(["--ref-checkpoint", "a", "--llm", "b",
                                 "--out", str(tmp_path / "o.pt")])
