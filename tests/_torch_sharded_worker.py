"""One rank of the sharded-generation tests (tests/test_torch_sharded_
generation.py), run under `_torch_dist.run_ranks`:

    python tests/_torch_sharded_worker.py JOB.pt OUT.pt

``JOB.pt`` (written by the test) holds the mesh, the port's state dict of
the tiny preset (from `utils.from_flax`), the inputs and the injected draws.
The rank builds the model on the CPU, runs every call of `ShardedGenerator`
on the mesh (gloo), then the int8 runtime on a second build, and rank 0
saves what they returned to ``OUT.pt``.  Imports no JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import sys

import torch
import torch.distributed as dist

import mm_interleaved_tpu_torch.configs as tcfg
from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig
from mm_interleaved_tpu_torch.models.llama import KVCache
from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
from mm_interleaved_tpu_torch.ops.quant import QLinear, quantize_llm_weights
from mm_interleaved_tpu_torch.parallel.inference import ShardedGenerator
from mm_interleaved_tpu_torch.parallel.partition import make_mesh


def tiny_model(state):
    cfg = tcfg.tiny_config(with_image_decoder=True)
    cfg = dataclasses.replace(cfg, image_decoder=dataclasses.replace(
        cfg.image_decoder, vae_decode_dtype="float32"))
    model = build_model(cfg, "cpu", torch.float32)
    model.load_state_dict(state, strict=True)
    return model


def gen_cfgs(special, new_tokens):
    kw = dict(max_new_tokens=new_tokens, pad_token_id=special.pad_token_id,
              eos_token_ids=(special.eos_token_id, special.soi_token_id))
    return dict(greedy=TextGenerationConfig(**kw),
                beam=TextGenerationConfig(num_beams=2, **kw),
                sampled=TextGenerationConfig(do_sample=True, top_p=0.9, **kw))


def run(gen, job):
    """Every call of the runtime on the job's inputs -> a dict of
    outputs."""
    x = job["inputs"]
    args = (x["text_ids"], x["image_tensors"], x["num_image_per_seq"],
            x["attention_mask"])
    cfgs = gen_cfgs(gen.model.cfg.special, job["new_tokens"])
    out = {}
    caches = []
    create = KVCache.create

    def recording(*a, **kw):
        cache = create(*a, **kw)
        caches.append(tuple(cache.k.shape))
        return cache

    KVCache.create = recording
    try:
        out["greedy"] = gen.generate_texts(*args, cfg=cfgs["greedy"])
    finally:
        KVCache.create = create
    out["cache_shape"] = caches[0]
    out["beam"] = gen.generate_texts(*args, cfg=cfgs["beam"])
    out["sampled"] = gen.generate_texts(
        *args, cfg=cfgs["sampled"],
        generator=torch.Generator().manual_seed(job["seed"]))
    inputs = gen.generate_image_inputs(*args)
    out["image_inputs"] = inputs
    tgt = job["targets"]
    sel = [None if v is None else v[tgt] for v in inputs]
    kw = dict(num_inference_steps=job["steps"], guidance_scale=3.0)
    out["images"] = gen.denoise(*sel, latents=job["latents"],
                                noises=job["noises"], **kw)
    out["images_drawn"] = gen.denoise(
        *sel, generator=torch.Generator().manual_seed(job["seed"]), **kw)
    out["scores"] = gen.generate_scores(
        x["text_ids"], job["options_ids"], job["options_mask"],
        x["image_tensors"], x["num_image_per_seq"], x["attention_mask"])
    odd = job["odd"]
    out["odd_greedy"] = gen.generate_texts(
        odd["text_ids"], odd["image_tensors"], odd["num_image_per_seq"],
        odd["attention_mask"], cfg=cfgs["greedy"])
    return out


def int8_codes_equal(model, whole, mesh) -> bool:
    """Each local int8 layer's codes and scales are the whole layer's
    quantized whole, cut as the plan cuts them, bit for bit."""
    from mm_interleaved_tpu_torch.parallel.partition import (axis_sizes,
                                                             placement_for)

    sizes = axis_sizes(mesh)
    t = sizes["tensor"]
    r = mesh.get_local_rank("tensor")
    mods = dict(whole.named_modules())
    n = 0
    for name, m in model.named_modules():
        if not isinstance(m, QLinear):
            continue
        for leaf in ("weight", "scale"):
            mine = getattr(m, leaf)
            if hasattr(mine, "full_tensor"):
                mine = mine.full_tensor()
            full = getattr(mods[name], leaf)
            dim = placement_for(f"{name}.{leaf}", full.shape, sizes).tensor
            if dim is not None:
                k = full.shape[dim] // t
                full = full.narrow(dim, r * k, k)
            if not torch.equal(mine, full):
                return False
            n += 1
    return n > 0


def main(job_path: str, out_path: str) -> None:
    dist.init_process_group("gloo")
    job = torch.load(job_path, weights_only=False)
    mesh = make_mesh(*job["mesh"], device_type="cpu")
    gen = ShardedGenerator(tiny_model(job["state"]), mesh)
    out = run(gen, job)
    model = tiny_model(job["state"])
    whole = copy.deepcopy(model)
    quantize_llm_weights(whole)
    q = ShardedGenerator(model, mesh, quantize="int8")
    x = job["inputs"]
    cfg = gen_cfgs(q.model.cfg.special, job["new_tokens"])["greedy"]
    out["int8_greedy"] = q.generate_texts(
        x["text_ids"], x["image_tensors"], x["num_image_per_seq"],
        x["attention_mask"], cfg=cfg)
    out["int8_codes_equal"] = torch.tensor(
        int8_codes_equal(q.model, whole, mesh))
    flags = [None] * dist.get_world_size()
    dist.all_gather_object(flags, bool(out["int8_codes_equal"]))
    out["int8_codes_equal_every_rank"] = all(flags)
    if dist.get_rank() == 0:
        torch.save(out, out_path)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
