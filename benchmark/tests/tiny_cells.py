"""Tiny cells for the CPU tests: the port's tiny preset in float32 under
small copies of the two mixes, served to the harness in place of the
files it finds by name."""

from __future__ import annotations

import dataclasses
import json

from benchmark.harness import check, spec

TINY_T2I = dict(
    name="tiny-t2i", entry="generate_images", batch=3, template_seed=0,
    blocks=[1, 2], lead_text=[2, 6], block_text=[2, 4], final="image",
    padding="right", num_inference_steps=3, guidance_scale=3.5,
    sampler="ddpm", warmup_units=1, profile_units=1, check_images=2)
TINY_VQA = dict(
    name="tiny-vqa", entry="generate_texts", batch=3, template_seed=0,
    blocks=[2, 2], lead_text=[0, 0], block_text=[3, 6], final="image_text",
    final_text=[2, 4], padding="left", num_beams=3, max_new_tokens=5,
    min_new_tokens=0, length_penalty=0.0, warmup_units=1, profile_units=1,
    check_units=2)
# the tiny preset's readings of sound runs sit under 1e-5 (float32 on
# both sides); these limits are the faults' to fail
TINY_LIMITS = {"tiny.t2i": {"image_rms_gap": 1e-3},
               "tiny-int8.vqa": {"logprob_gap": 1e-3,
                                 "served_rank_gap": 1e-3}}


def tiny_config(quantize=None) -> dict:
    from mm_interleaved_tpu_torch.configs import tiny_config as tiny

    model = dataclasses.asdict(tiny(dtype="float32", max_num_images=3))
    model["image_decoder"]["vae_decode_dtype"] = "float32"
    return dict(name="tiny-int8" if quantize else "tiny",
                source="the port's tiny preset", dtype="float32",
                quantize=quantize, reduced=[], model=model)


def bench() -> dict:
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    return dict(real, workloads=[
        dict(name="tiny.t2i", config="tiny", traffic="tiny-t2i", chips=1,
             why="tests"),
        dict(name="tiny-int8.vqa", config="tiny-int8", traffic="tiny-vqa",
             chips=1, why="tests")])


def install(monkeypatch) -> None:
    configs = {"tiny": tiny_config(), "tiny-int8": tiny_config("int8")}
    mixes = {"tiny-t2i": TINY_T2I, "tiny-vqa": TINY_VQA}
    monkeypatch.setattr(spec, "benchmark", bench)
    monkeypatch.setattr(spec, "config_spec", lambda n: configs[n])
    monkeypatch.setattr(spec, "traffic_spec", lambda n: mixes[n])
    monkeypatch.setattr(check, "limits", lambda n: TINY_LIMITS[n])
