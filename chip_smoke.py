#!/usr/bin/env python3
"""Drive the PyTorch port (`mm_interleaved_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and exits nonzero) on failure:

1. environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmuls and convolutions;
2. build every CUDA kernel under ``mm_interleaved_tpu_torch/csrc/`` (one
   nvcc each, in parallel) and print how long it took;
3. small reference: the tiny preset with its image decoder in fp32 on the
   card (kernels) against the same weights on the CPU (plain versions):
   text logits along greedy tokens, then `generate_image_inputs` and 3
   DDPM steps of `generate_images` with the same injected latents and
   noise, images within 1e-4; beam search (K = 3, stopping on <eos> or
   <soi>) gives the CPU's tokens;
4. the flagship preset with its image decoder (Vicuna-13B width and depth,
   CLIP ViT-L/14 + adapter, 12-layer Q-Former, the SD-2.1-base UNet with
   MMFS over four pyramid levels, the SD VAE, 512 px) in bf16 with seeded
   random weights made on the card;
5. the text slice: `generate_texts` for B=2, 256-token prompts with 2
   images each, 32 greedy tokens, eos off: shapes, finite logits, tokens
   in vocabulary, two runs identical, kernel 1's launch count equal to the
   path's call count;
6. the image slice on the same prompt: `generate_image_inputs`, then
   `generate_images` on all 4 target rows, 25 DDPM steps, guidance 3.5:
   images [4, 512, 512, 3], finite, in [0, 1], two seeded runs identical,
   the live rows moved by the MMFS values, and every kernel's launch count
   equal to the count derived from the config (each GroupNorm call, with
   or without the SiLU, one launch of each of its two kernels);
7. each kernel against its plain version on the inputs captured at each
   distinct call shape of the path, and at the first call of the tiny
   preset's image path (whose widths take the kernels' CUDA-core variants
   in bf16), in bf16 and fp32, each timed with CUDA events (median of 25),
   beside its bound and, for flash attention,
   `scaled_dot_product_attention`; flash attention, the mi MMFS readout
   and GEGLU also read as device time under `torch.profiler` and as the
   mean of 25 calls enqueued back to back (the exp ceiling logged on its
   own line), GEGLU beside the unfused path of the C = 1280 blocks
   (``unfused_ms``), the mi sites with the spread of their sampling
   offsets in texels per level; then
   the bf16 flash forward at the `FLASH_EDGES` shapes no site has
   (lengths that straddle its tiles, causal with Tq < Tk and with a query
   tile before the first key, segment ids that leave rows without a key,
   and the mma.sync bodies at D = 32 and 96): within one bf16 ulp of its
   plain version, output and LSE against attention in fp64; GEGLU at the
   `GEGLU_EDGES` and the mi readout at the `MI_EDGES` (ragged token and
   query counts, other widths and the variants they take, three images
   masked for some heads only, no CFG sharing, uniform locations), each
   within one bf16 ulp of its plain version and bit-identical over two
   runs, and a misaligned view refused before any launch at the widths
   of the Hopper variants; GroupNorm(+SiLU) as the whole op (moments and
   apply kernels, two launches a call) at every distinct call shape of the
   UNet and the VAE decoder, each kernel on its own too, within one bf16
   ulp (fp32: 1e-5) of the plain version and bit-identical over two runs,
   timed as events, device time by kernel and back to back, and at the
   `GN_EDGES` shapes (the scalar body, groups straddling vectors, one
   group, one row, B = 1, a large mean against fp64 with a derived
   tolerance, a CTA whose last warp is partial, a misaligned view
   refused); the captured inputs of kernels
   4 and 7 and GroupNorm saved under ``build/sites/`` for
   `bench_unet_kernels --sites`;
8. training: (a) right after phase 3, one `Trainer` step of the tiny preset
   with its image decoder, fp32, on the card against the CPU with the same
   injected draws: loss within 1e-5 relative, every trainable gradient
   within 1e-4 of its scale, then one `Trainer` step at the default lr:
   the gradient norm within 1e-5 relative, Adam's moments within the
   gradients' tolerance, each master's update equal to AdamW's formula
   from the card's own moments (its first call of each backward kernel is
   the ``tiny`` site);
   (b) after phase 7, the flagship in its training form (frozen leaves as
   the JAX package freezes them, bf16 compute, fp32 masters in the
   optimizer, remat as configured, ``warmup_steps=0``: optax's first
   update is at count 0) on the phase 5-6 prompt with 512 px targets:
   step 1 twice from one state (the same loss, gradient norm and fp32
   masters, bit for bit: every kernel of the step sums in a fixed order),
   then steps 2 and 3; finite metrics, frozen leaves
   bit-identical, every trainable group moved, every kernel's launch count
   equal to the count derived from the config, one step under
   `torch.profiler`; (c) each backward kernel against the plain version's
   autograd at every distinct training call shape and at ``tiny``, in
   bf16 and fp32, timed beside its bound and, for flash attention,
   autograd through `scaled_dot_product_attention` (both also as device
   time under `torch.profiler` and enqueued back to back); flash
   attention's training forward (output and LSE) against attention in
   fp64 there;
   the bf16 flash backward bit-identical over two runs at UNet attn1
   64 px, and at the `FLASH_EDGES` shapes against fp64 autograd with the
   sites' tolerances, bit-identical over two runs; the value gradient
   (kernel 2) and the location/weight gradient (kernel 3) bit-identical at
   every site, read as device time and back to back; kernel 1 against its
   plain version at every training site too (bf16 and fp32, bit-identical
   over two runs); kernels 1, 2 and 3 at the `DEFORM_BWD_EDGES` (D = 32,
   128, every corner out of bounds, L * P = 9, fp32 values, fp32
   locations with bf16 values, every sample in one cell, a level whose
   cell table sits in device memory, the bodies for any D at D = 16 and
   20, a misaligned view refused), bit-identical over two runs; the
   captured inputs of kernels 1, 2 and 3 saved beside phase 7's;
9. the deformable-kernel benchmark (`mm_interleaved_tpu_torch.
   bench_deform_kernel.run`): the v1 and v4 kernels and kernel 1 at its
   unet and prefill cases, bf16, each timed (median of 25), the v1 and v4
   launch counts equal to the calls made; then v1 and v4 each against its
   plain version (bf16 within 2 ulps at the output's scale, fp32 within
   1e-5 of it) and against kernel 1 (bf16 2e-2, fp32 1e-4 of kernel 1's
   scale) at both cases, in bf16 and fp32, beside the bound of the
   function (`work_deform`, as kernel 1's), kernel 1's time on the same
   inputs and the design's own operation count; then v1 (kernel 9, on
   kernel 1's grouped body where `forward_variant` says "grouped") at the
   `V1_EDGES` (D = 16 to 128, fp32, bf16 locations, corners outside the
   grid, whole-texel coordinates, L * P over 32, the "channel" body at
   fp32 D = 20) against its plain version, bit-identical over two calls,
   and a misaligned value refused before any launch;
10. the v4-against-v5 benchmark (`mm_interleaved_tpu_torch.
   bench_v5_kernel.run`): v4 (kernels 8a, 8b, 8c through
   `MSDeformAttnV4Function`) and v5 (kernels 1, 2, 3), forward and forward
   + backward, at its unet and prefill cases under clustered and uniform
   locations, bf16, each timed (median of 25); every kernel's launches
   equal to the calls that reach it; each row finite, v4 within 2e-2 of v5;
   then the v4 value and location/weight gradient kernels against their
   plain versions (dV 2 bf16 ulps, d_loc and d_w 1e-4 of their scales in
   bf16; 1e-5 in fp32) and against kernels 2 and 3 (dV 2e-2, d_loc and d_w
   1e-3 in bf16; 1e-4 in fp32; d_loc away from the hat's kinks) at all four
   cases, in bf16 and fp32, the benchmark's own gradients equal to the
   kernels', beside the bounds of kernels 2 and 3 (the same function),
   their times on the same inputs and the design's own operation count;
   then the v4 gathers (8a, 8b, 8c) at the `V4_EDGES` (whole-texel
   coordinates, corners outside the grid, a query's points on one spot,
   P = 1, 8, 9 and 64, non-square levels, D = 16 to 128 in bf16 and fp32,
   fp32 D = 18, bf16 locations, a value view off a 16-byte boundary, a
   128 x 128 level whose texel table 8b keeps in device memory) against
   their plain versions with the sites' tolerances, bit-identical over two
   calls, 8b's plan logged and a grad_out off a 16-byte boundary refused
   by 8b before any launch;
11. the training entry point (`mm_interleaved_tpu_torch.train.main`) on
   ``build/smoke_train.yaml``: `configs/pretrain_synthetic.yaml` with the
   flagship preset (``seq_len`` 256, 2 image slots a row), 2 rows a batch,
   3 steps, no warm-up, from the synthetic data source through the data
   layer: three finite step lines, frozen leaves bit-identical, every
   trainable group moved, each kernel's launches equal to the count
   derived from the config for the image slots of the pipeline's batches,
   the final checkpoint written (size and write time logged) and deleted;
   the data path's host ms a batch, timed alone; then the resume check at
   the tiny preset: a run killed in step 3 and resumed from its step-2
   checkpoint gives step 3's metrics, masters and moments bit for bit as
   an uninterrupted run;
12. the interleaved-turn benchmark (`mm_interleaved_tpu_torch.bench.run`)
   at its defaults but one timed turn (base preset, B = 2, 32 tokens, 25
   CFG steps, decode at B = 8): its line printed, every value finite and
   positive, both utilisation estimates under 1.05, every kernel's
   launches equal to the count derived from the base config, over the run
   and over the first timed turn, whose counts are read in a window of
   their own;
13. the training-step benchmark (`mm_interleaved_tpu_torch.bench_train.
   run`), small and base sections, 2 timed steps each: finite, positive
   fields, a measured base full step, every kernel of the step launched;
14. the serving path at the flagship (its seeded weights built again, bf16):
   (a) `generate_texts` with beam search on the phase 5 prompt at the
   caption defaults (K = 5, 20 tokens, min 8) and the VQA defaults (K = 3,
   10 tokens): tokens in vocabulary, two runs identical, kernel 1's
   launches the derived count, ms/token and peak memory beside greedy's,
   and K = 1 equal to phase 5's greedy tokens; (b) the inference entry
   point (`mm_interleaved_tpu_torch.inference.main`) on
   ``build/smoke_inference.yaml``, text -> image -> text over two synthetic
   jpgs, its PNG at 512 px, each turn's wall and launches against the
   derived counts (10 denoise steps, `SERVE_STEPS`, here and in 16d); (c)
   the evaluation entry point
   (`mm_interleaved_tpu_torch.evaluate.main`) on ``build/smoke_eval.yaml``:
   captions (5 beams), VQA (3 beams), VisDial ranking, grounding, text to
   image with CLIP-FID and storytelling on synthetic files, one finite
   ``eval_metrics.jsonl`` row each, each route's launches the derived
   count and its samples/s;
15. weights from files, at the flagship's widths with 4 LLM layers (one
   MMFS layer): (a) a released-format checkpoint (the converter's keys and
   shapes, the fixed buffers it skips), seeded bf16 in two safetensors
   shards, converted by ``python -m mm_interleaved_tpu_torch.convert_checkpoint
   --ref-checkpoint`` on the card (its GB/s and peak host RSS), every port
   parameter equal to its transformed source tensor, loaded by
   `load_model`, then phase 5's text slice and a 5-step CFG denoise of
   phase 6 on it, their launches the derived counts; (b) the tower mode on
   HF-named LLaMA shards, a CLIP vision directory and a diffusers unet/ +
   vae/ pair: every converted tensor equal to its source, the padded
   embedding rows the mean embedding, the TextDecoder's heads as built;
   (c) `train.main` with ``load_from`` the tower output, one step: at its
   start the masters and the weights the file's, the moments zero, its
   launches the derived count; (d) the CLIP text tower at ViT-L/14's text
   width (fp32, 16 captions of 77 tokens) and the projected vision tower:
   kernel 5 at the causal text site against its plain version, both
   towers' features against the CPU's, the rerank's picks the CPU's; (e)
   InceptionV3 at 299 px against the CPU;
16. int8 weight-only decode, the benchmark datasets and RICES: (a) the
   tiny preset, fp32, quantized on the CPU and copied to the card: logits
   along the greedy tokens within 1e-4, the same tokens, the int8 kernel's
   launches derived; (b) the flagship of phase 4 quantized in place
   (`ops.quant.quantize_llm_weights`: the LLM's q/k/v/o, gate/up/down and
   both heads), the peak counter reset after, then phase 5's text slice
   (two runs identical), a K = 3 beam (two runs identical) and a 5-step
   CFG denoise of phase 6: every kernel's launches, the int8 kernel's
   among them, the derived counts; the peak beside phase 5's, at least 11
   GB lower; (d) `evaluate.main` at the flagship over the eight
   `datasets_bench` types on synthetic files in their official layouts
   (VIST twice: storytelling and captioning), one batch of 2 each, 25
   steps: one finite row a route, each route's launches the derived count,
   its samples/s; `Evaluator.evaluate_segm2img` with the nearest-palette
   segmenter (a finite mIoU); the nocaps route with ``evaluation.quantize:
   int8``; (c) the int8 kernel against its plain version at every captured
   shape (the prefill, decode at M = 2, 6 and 10, the prefix forward, the
   heads) and at M = 8, in bf16 and fp32, within its derived elementwise
   bound and bit-identical over two runs, timed beside its bound and
   `F.linear` on the dequantized weight (cuBLAS), the body and the wgmma
   body's plan that served each recorded, then at `INT8_EDGES` (K not a
   multiple of 16; N off the tiles, 2, 130 and 5000; M = 1, 9, 16, 17, 64,
   65, 257 and 512; K = 16, 48 and 5136; bias present and absent; a
   misaligned view refused); (e) RICES over 16 seeded images with
   a seeded ViT-L/14 in fp32: features within 1e-4 of their scale of the
   CPU's, the CPU's picks;
17. the sharded runtime (`parallel.inference.ShardedGenerator`): (a) at
   world size 1 on the flagship (a nccl group of one rank, ``make_mesh(1,
   1, 1)``): greedy tokens and the denoise of row 0's two images equal
   `LocalGenerator`'s on the same model bit for bit, each launch window
   its derived count; (b) tensor = 2 over two gloo processes on the card
   (``chip_smoke.py --tensor-rank R PORT DIR``), the flagship's widths
   with 8 LLM layers (2 MMFS): the teacher-forced and prompt logits no
   farther from the same weights' fp32 logits than 1.5 times the
   one-process bf16 run's distance, the first greedy token equal, each
   rank's cut weights half of the one-process bytes within 2%, kernels 1,
   5 and the int8 kernel held against their plain versions at the
   local-head and local-K shapes.

18. the sharded Trainer (`engine.trainer.Trainer` on a mesh): (a) the
   flagship's training form at world size 1 (a nccl group of one rank,
   ``make_mesh(1, 1, 1)``), one step on phase 8b's batch against the
   one-process `Trainer` on the same seeded weights, built again: the
   loss, the gradient norm and every master and both moments (by digest)
   bit for bit, each run's launches the derived count; (b) tensor = 2 over
   two gloo processes on the card (``chip_smoke.py --train-tensor-rank R
   PORT DIR``), the flagship's widths with 8 LLM layers (2 MMFS) and the
   image decoder, one step on one row: the loss, the norm and each
   trainable group's gradient no farther from the same weights' fp32 step
   than 1.5 times the one-process bf16 step, every gradient of a leaf
   whole over ``tensor`` the same bits on both ranks, kernels 1, 2, 3, 5
   and 5b at the local heads against their plain versions.

Phase 14 ends (14d) with the native image kernels' pixels on a seeded
image held to the CPU's digest, then the inference entry's first text
turn run again in a fresh process (``chip_smoke.py --turn-probe OUT``):
its text equal to 14b's in this process, and where the traced records
part, the first differing call logged.

Prints a ``{"kernels": [...]}`` line (all fourteen kernels, each with its
launches in the measured bench turn, its mean launches a train-entry
step, its launches over phase 14's counted runs, over phase 15's, over
phase 16's, over phase 17a's sharded run, over phase 17b's rank 0, over
phase 18a's sharded step and over phase 18b's rank 0; the
flash forward with its CLIP-text site, the int8 kernel with its edge
cases, kernels 1, 5 and the int8 kernel with their tensor-parallel sites,
kernels 1, 2, 3, 5 and 5b with their tensor-parallel training sites),
the
``nvidia-smi`` name/power line, and last ``{"ok": true, "device":
{...}}``.  Needs one CUDA card and the
repository checkout around it; imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np

# the port's timing helpers and the card's peak rates (this import fails,
# and the run with it, outside the repository checkout or without torch)
from mm_interleaved_tpu_torch.utils.timing import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, card_line, device_kernels,
    device_ms, device_ms_by_kernel, queued_ms, time_ms)
from mm_interleaved_tpu_torch.utils.timing import RUNS as TIMING_RUNS
from mm_interleaved_tpu_torch.utils.timing import nbytes as _nbytes

SEED = 0
B = 2
PROMPT_LEN = 256
N_IMG = 2
NEW_TOKENS = 32
IMG_STEPS = 25
GUIDANCE = 3.5
# exp2 on the special-function units: 16 per clock per SM, 132 SMs, at the
# 1.83 GHz that the bf16 peak assumes (989e12 / (132 * 4096 flops a clock))
PEAK_EXPS = 132 * 16 * 1.83e9
KERNELS = {
    "ms_deform_attn_fwd": dict(
        module="ms_deform_attn_cuda", kernel="ms_deform_attn_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:237 "
                 "_kernel_v5"),
    "ms_deform_attn_mi_fwd": dict(
        module="ms_deform_attn_mi", kernel="ms_deform_attn_mi_cuda",
        plain="ms_deform_attn_mi_plain", source="ms_deform_attn_mi.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_mi.py:68 "
                 "_kernel_mi"),
    "flash_attention_fwd": dict(
        module="flash_attention", kernel="flash_attention",
        plain="attention_plain", source="flash_attention.cu",
        replaces="mm_interleaved_tpu/ops/flash_attention.py:19 "
                 "flash_attention"),
    "group_norm_moments": dict(
        module="group_norm", kernel="group_norm_moments_cuda",
        plain="group_norm_moments_plain", source="group_norm_silu.cu",
        replaces="mm_interleaved_tpu/ops/group_norm.py:157 the moments of "
                 "group_norm_silu and group_norm (XLA reductions on the TPU, "
                 "beside the Pallas apply at :74)"),
    "group_norm_apply": dict(
        module="group_norm", kernel="group_norm_apply_cuda",
        plain="group_norm_apply_plain", source="group_norm_silu.cu",
        replaces="mm_interleaved_tpu/ops/group_norm.py:74 "
                 "_apply_silu_kernel"),
    "geglu_fwd": dict(
        module="geglu", kernel="geglu_cuda", plain="geglu_plain",
        source="geglu.cu",
        replaces="mm_interleaved_tpu/ops/geglu.py:67 _kernel"),
    "ms_deform_attn_bwd_value": dict(
        module="ms_deform_attn_cuda", kernel="ms_deform_attn_bwd_value_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:264 "
                 "_kernel_v5_bwd_dv"),
    "ms_deform_attn_bwd_loc_weight": dict(
        module="ms_deform_attn_cuda",
        kernel="ms_deform_attn_bwd_loc_weight_cuda",
        plain="ms_deform_attn_plain", source="ms_deform_attn_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v5.py:296 "
                 "_kernel_v5_bwd_dslab"),
    "flash_attention_bwd": dict(
        module="flash_attention", kernel="flash_attention_bwd",
        plain="attention_plain", source="flash_attention_bwd.cu",
        replaces="mm_interleaved_tpu/ops/flash_attention.py:19 "
                 "flash_attention (its backward: dkv, dq)"),
    "ms_deform_attn_v1_fwd": dict(
        module="ms_deform_attn_v1", kernel="ms_deform_attn_v1_cuda",
        plain="ms_deform_attn_v1_plain", source="ms_deform_attn_v1.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas.py:36 _kernel"),
    "ms_deform_attn_v4_fwd": dict(
        module="ms_deform_attn_v4", kernel="ms_deform_attn_v4_cuda",
        plain="ms_deform_attn_v4_plain", source="ms_deform_attn_v4.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py:157 "
                 "_kernel_v4"),
    "ms_deform_attn_v4_bwd_value": dict(
        module="ms_deform_attn_v4", kernel="ms_deform_attn_v4_bwd_value_cuda",
        plain="ms_deform_attn_v4_plain_bwd_value",
        source="ms_deform_attn_v4_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py:179 "
                 "_kernel_v4_bwd_dv"),
    "ms_deform_attn_v4_bwd_loc_weight": dict(
        module="ms_deform_attn_v4",
        kernel="ms_deform_attn_v4_bwd_loc_weight_cuda",
        plain="ms_deform_attn_v4_plain_bwd_loc_weight",
        source="ms_deform_attn_v4_bwd.cu",
        replaces="mm_interleaved_tpu/ops/ms_deform_attn_pallas_v4.py:215 "
                 "_kernel_v4_bwd_dslab"),
    "int8_linear": dict(
        module="quant", kernel="int8_linear_cuda", plain="int8_linear_plain",
        source="int8_linear.cu",
        replaces="mm_interleaved_tpu/ops/quant.py:85 QDense (no Pallas "
                 "kernel: the XLA fusion of the int8 convert and scale into "
                 "the dot's operand read)"),
}
# the forward kernels of the inference phases and the backward kernels of
# the training phase
FORWARD = ("ms_deform_attn_fwd", "ms_deform_attn_mi_fwd",
           "flash_attention_fwd", "group_norm_moments", "group_norm_apply",
           "geglu_fwd")
# the two kernels of every GroupNorm(+SiLU) call, captured and compared as
# the whole op (`group_norm_cuda`, "group_norm" in the captured cases)
GN = ("group_norm_moments", "group_norm_apply")
BACKWARD = ("ms_deform_attn_bwd_value", "ms_deform_attn_bwd_loc_weight",
            "flash_attention_bwd")
# the int8 weight-only kernel of the quantized LLM (phase 16)
QUANT = ("int8_linear",)
# the benchmark's kernels (phase 9), by their formulation's name there
BENCH = {"ms_deform_attn_v1_fwd": "v1", "ms_deform_attn_v4_fwd": "v4"}
# the v4 backward kernels (phase 10), and the calls of the v4-against-v5
# benchmark that launch each kernel of its path
V4_BWD = ("ms_deform_attn_v4_bwd_value", "ms_deform_attn_v4_bwd_loc_weight")
V5_BENCH_LAUNCHES = {
    "ms_deform_attn_v4_fwd": ("v4_fwd", "v4_fwd_bwd"),
    "ms_deform_attn_v4_bwd_value": ("v4_fwd_bwd",),
    "ms_deform_attn_v4_bwd_loc_weight": ("v4_fwd_bwd",),
    "ms_deform_attn_fwd": ("v5_fwd", "v5_fwd_bwd"),
    "ms_deform_attn_bwd_value": ("v5_fwd_bwd",),
    "ms_deform_attn_bwd_loc_weight": ("v5_fwd_bwd",),
}
# the plain versions at the benchmark's unet case take tens of ms a call
PLAIN_RUNS = 5
TRAIN_STEPS = 3


def log(*a):
    print(*a, flush=True)


def kmod(name):
    import importlib

    return importlib.import_module(
        f"mm_interleaved_tpu_torch.ops.{KERNELS[name]['module']}")


def kernel_of(name):
    return getattr(kmod(name), KERNELS[name]["kernel"])


def reset_counts():
    for name in KERNELS:
        kernel_of(name).launches = 0


def read_counts():
    return {name: kernel_of(name).launches for name in KERNELS}


def perturb_zero_inits(model, seed: int) -> None:
    """Small seeded values for the parameters the JAX init leaves at zero
    (gates, gammas, deformable offset/weight kernels, ignore tokens, the
    UNet MMFS blocks' output convs), so that the deformable branches reach
    the logits and the pixels."""
    import torch

    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        parent = name.rsplit(".", 2)[-2] if name.count(".") else ""
        if leaf in ("gate", "gamma"):
            p.data.normal_(0.0, 0.3, generator=g)
        elif leaf in ("ignore_token", "adapter_level_embed"):
            p.data.normal_(0.0, 0.1, generator=g)
        elif parent in ("sampling_offsets", "attention_weights") \
                and leaf == "weight":
            p.data.normal_(0.0, 0.5 * p.shape[1] ** -0.5, generator=g)
        elif parent == "conv" and ".mmfs_net." in name:
            std = 0.5 * p.shape[1] ** -0.5 if leaf == "weight" else 0.1
            p.data.normal_(0.0, std, generator=g)


def make_prompt(special, rng: np.random.RandomState, n_img_tok: int):
    """B rows of PROMPT_LEN tokens: <bos>, text, then N_IMG blocks of
    <soi> + n_img_tok <image>, each followed by text; row 1 is left-padded
    by 8 tokens.  One document per row, so each row's image 2 has image 1
    as its previous image."""
    def text(n):
        return list(rng.randint(3, special.pad_token_id, size=n))

    body_text = PROMPT_LEN - 1 - N_IMG * (1 + n_img_tok)
    chunk = (body_text - 8 * (B - 1)) // (N_IMG + 1)
    rows, masks = [], []
    for b in range(B):
        pad = 8 * b
        n_text = body_text - pad
        parts = [special.bos_token_id] + text(chunk)
        for _ in range(N_IMG):
            parts += [special.soi_token_id] + [special.image_token_id] * n_img_tok
            parts += text(chunk)
        parts += text(n_text - (N_IMG + 1) * chunk)
        row = [special.pad_token_id] * pad + parts
        assert len(row) == PROMPT_LEN, len(row)
        rows.append(row)
        masks.append([0] * pad + [1] * (PROMPT_LEN - pad))
    return np.array(rows, np.int64), np.array(masks, np.int32)


# --------------------------------------------------------------------------
# capturing each kernel's inputs at each distinct call site


def _site_deform(value, shapes, loc, w):
    L, P, Q = loc.shape[3], loc.shape[4], loc.shape[1]
    if P == 4:
        return "injector" if L > 1 else "extractor"
    return "mmfs_prefill" if Q > 1 else "mmfs_decode"


def _site_mi(value, delta, shapes, ref, off_q, wq, inv_base):
    return f"unet_{int(round(off_q.shape[1] ** 0.5))}px"


def _site_flash(q, k, v, causal=False, **kw):
    """The module making the call, told apart by shape; a shape of no known
    call gets a name of its own, which fails the capture check."""
    _, Tq, H, D = q.shape
    Tk = k.shape[1]
    px = int(round(Tq ** 0.5))
    if causal:
        return "llm_prefix"
    if Tq == Tk == 257:
        return "vit"
    if H in (12, 6):  # the Q-Former's heads, all or a rank's at tensor = 2
        return "qformer_self" if Tq == Tk else "qformer_cross"
    if Tq == Tk == 77:
        return "decoder_perceiver"
    if px * px == Tq and Tk in (Tq, 77):
        return f"unet_attn{1 if Tk == Tq else 2}_{px}px"
    return f"Tq{Tq}_Tk{Tk}_H{H}_D{D}"


def _site_gn(x, scale, bias, num_groups, eps, silu):
    """Every call shape of the whole op (`gn_site_keys` lists the image
    path's)."""
    return gn_key(x.shape[0], x.shape[1], x.shape[-1], silu)


def gn_key(batch, px, C, silu):
    return f"b{batch}_{px}px_c{C}_{'silu' if silu else 'norm'}"


def _site_geglu(x, w1, b1, w2, b2):
    return f"C{x.shape[-1]}"


def _site_deform_bwd(value, shapes, loc, w, grad_out):
    L, P, Q = loc.shape[3], loc.shape[4], loc.shape[1]
    if P == 4:
        return "injector" if L > 1 else "extractor"
    if L == 4:
        return f"unet_{int(round(Q ** 0.5))}px"
    return "mmfs_llm"


def _site_flash_bwd(q, k, v, grad_out, lse, **kw):
    return _site_flash(q, k, v, **kw)


SITES = {
    "ms_deform_attn_fwd": _site_deform,
    "ms_deform_attn_mi_fwd": _site_mi,
    "flash_attention_fwd": _site_flash,
    "group_norm": _site_gn,
    "geglu_fwd": _site_geglu,
    "ms_deform_attn_bwd_value": _site_deform_bwd,
    "ms_deform_attn_bwd_loc_weight": _site_deform_bwd,
    "flash_attention_bwd": _site_flash_bwd,
}
# "tiny" is the first call of the tiny preset's image path: its widths (head
# dim 8, GEGLU width 16) take the kernels' CUDA-core variants in bf16
TINY = "tiny"
WANT_SITES = {
    "ms_deform_attn_fwd": ["extractor", "injector", "mmfs_decode",
                           "mmfs_prefill", TINY],
    "ms_deform_attn_mi_fwd": ["unet_64px", "unet_32px", "unet_16px",
                              "unet_8px", TINY],
    "flash_attention_fwd": ["llm_prefix", "vit", "qformer_self",
                            "qformer_cross", "decoder_perceiver",
                            "unet_attn1_64px", "unet_attn1_32px",
                            "unet_attn1_16px", "unet_attn1_8px",
                            "unet_attn2_64px", "unet_attn2_32px",
                            "unet_attn2_16px", "unet_attn2_8px", TINY],
    "geglu_fwd": ["C320", "C640", TINY],
}
# where a capture wraps a whole op rather than a kernel's wrapper: name ->
# (module under ops/, attribute)
CAPTURE_AT = {"group_norm": ("group_norm", "group_norm_cuda")}
_DEFORM_TRAIN = ["injector", "extractor", "mmfs_llm", "unet_64px",
                 "unet_32px", "unet_16px", "unet_8px", TINY]
WANT_SITES.update({
    "ms_deform_attn_bwd_value": _DEFORM_TRAIN,
    "ms_deform_attn_bwd_loc_weight": _DEFORM_TRAIN,
    "flash_attention_bwd": WANT_SITES["flash_attention_fwd"],
})


def check_sites(name, cases):
    got = sorted(cases.get(name, {}))
    if got != sorted(WANT_SITES[name]):
        raise AssertionError(f"{name}: captured sites {got} != "
                             f"{sorted(WANT_SITES[name])}")


@contextlib.contextmanager
def capture(names, cases, site=None):
    """Wrap each kernel's wrapper to keep (clones of) the first inputs of
    each call site in ``cases[name][site]``; a fixed ``site`` names the
    first call alone."""
    import torch

    import importlib

    saved = []
    for name in names:
        mod_name, attr = CAPTURE_AT.get(name) or (KERNELS[name]["module"],
                                                  KERNELS[name]["kernel"])
        mod = importlib.import_module(f"mm_interleaved_tpu_torch.ops.{mod_name}")
        orig = getattr(mod, attr)
        site_of = SITES[name] if site is None else (lambda *a, **k: site)
        store = cases.setdefault(name, {})

        def wrapped(*args, _orig=orig, _site=site_of, _store=store, **kw):
            key = _site(*args, **kw)
            if key is not None and key not in _store:
                _store[key] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args), {
                    k: v.clone() if isinstance(v, torch.Tensor) else v
                    for k, v in kw.items()}
            return _orig(*args, **kw)

        setattr(mod, attr, wrapped)
        saved.append((mod, attr, orig))
    try:
        yield cases
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def _ulps(scale, n=1):
    """``n`` bf16 ulps at ``scale``."""
    return float(n * 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7))


# --------------------------------------------------------------------------
# the small reference


def teacher_forced_logits(model, text_ids, images, n_img, att, tokens):
    """Prefill logits of the last prompt position, then the logits of each
    decode step fed ``tokens`` (as `generate_tokens` feeds its own)."""
    import torch

    from mm_interleaved_tpu_torch.models.llama import KVCache

    with torch.inference_mode():
        prep = model.prepare_mm_embeds(text_ids, images, n_img)
        cache = KVCache.create(model.cfg.llm, text_ids.shape[0],
                               text_ids.shape[1] + tokens.shape[1],
                               device=text_ids.device,
                               dtype=model.soi_token.dtype,
                               kv_heads=model.mm_decoder.kv_heads)
        logits, _, cache, values = model.lm_prefill(
            prep["mm_embeds"], att, prep["mmfs_values"],
            prep["cross_attention_mask"], cache,
        )
        out = [logits[:, -1].float()]
        cross = prep["cross_attention_mask"][:, -1:]
        ones = torch.ones_like(att[:, :1])
        for t in range(tokens.shape[1] - 1):
            step, cache = model.lm_decode_step(
                tokens[:, t:t + 1], ones, None, cross, cache, values
            )
            out.append(step[:, 0].float())
    return torch.stack(out, dim=1)


def small_reference(cases) -> dict:
    """Tiny preset with its image decoder, fp32: the card (kernels) against
    the CPU (plain versions).  Keeps the first inputs of each kernel on the
    card's image path as its ``TINY`` site."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.generation.diffusion import generate_images
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, image_decoder=dataclasses.replace(
        cfg.image_decoder, vae_decode_dtype="float32"))
    s = cfg.special
    cpu = build_model(cfg, "cpu", torch.float32, seed=SEED)
    perturb_zero_inits(cpu, SEED + 1)
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(SEED)
    row = [s.bos_token_id, 5, s.soi_token_id] + [s.image_token_id] * \
        cfg.num_img_token + [7, 8, s.soi_token_id] + \
        [s.image_token_id] * cfg.num_img_token + [9]
    ids = torch.tensor([row, [s.pad_token_id] + row[:-1]])
    att = (ids != s.pad_token_id).int()
    imgs = torch.from_numpy(
        rng.rand(2, cfg.max_num_images, 56, 56, 3).astype(np.float32))
    n_img = torch.tensor([2, 2])
    gen = TextGenerationConfig(max_new_tokens=8, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    tok_cpu = generate_texts(cpu, ids, imgs, n_img, att, gen)
    want = teacher_forced_logits(cpu, ids, imgs, n_img, att, tok_cpu)
    dev = [t.cuda() for t in (ids, imgs, n_img, att, tok_cpu)]
    reset_counts()
    got = teacher_forced_logits(gpu, *dev).cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"tiny fp32 logits card vs CPU: {err} "
                             f"(scale {scale})")
    tok_gpu = generate_texts(gpu, *dev[:4], gen).cpu()
    top2 = want.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    if margin > 10 * err and not torch.equal(tok_gpu, tok_cpu):
        raise AssertionError(f"tiny greedy tokens differ: {tok_gpu} vs "
                             f"{tok_cpu}")
    # beam search, K = 3, stopping on <eos> or <soi> after 2 tokens
    beam = dataclasses.replace(gen, num_beams=3, min_new_tokens=2,
                               eos_token_ids=(s.eos_token_id,
                                              s.soi_token_id))
    beam_cpu = generate_texts(cpu, ids, imgs, n_img, att, beam)
    beam_gpu = generate_texts(gpu, *dev[:4], beam).cpu()
    if not torch.equal(beam_gpu, beam_cpu):
        raise AssertionError(f"tiny beam tokens (K=3) differ: {beam_gpu} "
                             f"vs {beam_cpu}")

    # the image path: the same prompt, injected draws
    steps = 3
    inp_cpu = cpu.generate_image_inputs(ids, imgs, n_img, att)
    with capture([*KERNELS, "group_norm"], cases, site=TINY):
        inp_gpu = gpu.generate_image_inputs(*dev[:4])
    inputs_err = max(float((a.cpu().float() - b.float()).abs().max())
                     for a, b in zip(inp_gpu, inp_cpu))
    if not inputs_err <= 1e-4:
        raise AssertionError(f"tiny generate_image_inputs card vs CPU: "
                             f"{inputs_err}")
    if int(inp_cpu[3].sum()) == 0:
        raise AssertionError("tiny prompt has no previous image")
    idc = cfg.image_decoder
    shape = (inp_cpu[0].shape[0], idc.latent_size, idc.latent_size,
             idc.vae.latent_channels)
    latents = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    noises = torch.from_numpy(rng.randn(steps, *shape).astype(np.float32))
    kw = dict(num_inference_steps=steps, guidance_scale=2.0)
    img_cpu = generate_images(cpu, *inp_cpu, latents=latents, noises=noises,
                              **kw)
    with capture([*KERNELS, "group_norm"], cases, site=TINY):
        img_gpu = generate_images(gpu, *inp_gpu, latents=latents.cuda(),
                                  noises=noises.cuda(), **kw).cpu()
    img_err = float((img_gpu - img_cpu).abs().max())
    if not img_err <= 1e-4:
        raise AssertionError(f"tiny images card vs CPU: {img_err}")
    counts = read_counts()
    if any(counts[n] == 0 for n in FORWARD):
        raise AssertionError(f"tiny card run missed a kernel: {counts}")
    return dict(logits_max_abs_err=err, logits_scale=scale,
                top2_margin=margin, tokens_equal=torch.equal(tok_gpu, tok_cpu),
                beam_tokens=beam_cpu.tolist(),
                image_inputs_max_abs_err=inputs_err,
                images_max_abs_err=img_err, launches=counts)


def tiny_train_batch(cfg, rng):
    """The small reference's prompt as a training batch (two rows, two
    images in one document each, 16 px targets) with the image decoder's
    draws for its 6 image slots (one uncond drop)."""
    import torch

    s = cfg.special
    row = [s.bos_token_id, 5, s.soi_token_id] + [s.image_token_id] * \
        cfg.num_img_token + [7, 8, s.soi_token_id] + \
        [s.image_token_id] * cfg.num_img_token + [9]
    ids = torch.tensor([row, [s.pad_token_id] + row[:-1]])
    idc = cfg.image_decoder
    n = 2 * cfg.max_num_images
    lat = (n, idc.latent_size, idc.latent_size, idc.vae.latent_channels)
    f32 = np.float32
    batch = dict(
        text_ids=ids, attention_mask=(ids != s.pad_token_id).int(),
        image_tensors=torch.from_numpy(
            rng.rand(2, cfg.max_num_images, 56, 56, 3).astype(f32)),
        num_image_per_seq=torch.tensor([2, 2]),
        image_tensors_dec=torch.from_numpy(
            rng.rand(2, cfg.max_num_images, idc.image_size, idc.image_size,
                     3).astype(f32)))
    draws = dict(
        vae_noise=torch.from_numpy(rng.randn(*lat).astype(f32)),
        noise=torch.from_numpy(rng.randn(*lat).astype(f32)),
        timesteps=torch.from_numpy(
            rng.randint(0, idc.schedule.num_train_timesteps, n)),
        uncond_drop=torch.arange(n) == 1)
    return batch, draws


def to_dev(d, device):
    return {k: v.to(device) for k, v in d.items()}


def grad_tolerances(want: dict) -> dict:
    """1e-4 x each leaf's scale, the larger of its largest gradient and 1e-3
    of the largest of all (a leaf whose exact gradient vanishes holds
    rounding noise only)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: 1e-4 * max(float(g.abs().max()), 1e-3 * top)
            for n, g in want.items()}


def small_training_reference(cases) -> dict:
    """One training step of the tiny preset with its image decoder, fp32:
    the card (kernels) against the CPU (plain versions) from one seeded
    model and one set of draws.  Keeps the first inputs of each backward
    kernel as its ``TINY`` site.  Then one `Trainer` step on each, at the
    default lr, held by `adamw_check`."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = tiny_config()
    optim = OptimConfig(warmup_steps=0)
    cpu = build_model(cfg, "cpu", torch.float32, seed=SEED, optim=optim)
    perturb_zero_inits(cpu, SEED + 1)
    gpu = copy.deepcopy(cpu).cuda()
    batch, draws = tiny_train_batch(cfg, np.random.RandomState(SEED + 2))

    def loss_and_grads(model, device):
        out = model(**to_dev(batch, device), **to_dev(draws, device))
        out["loss"].backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.requires_grad}
        for p in model.parameters():
            p.grad = None
        return {k: float(v.detach()) for k, v in out.items()}, grads

    want, g_cpu = loss_and_grads(cpu, "cpu")
    reset_counts()
    with capture(list(BACKWARD), cases, site=TINY):
        got, g_gpu = loss_and_grads(gpu, "cuda")
    counts = read_counts()
    if any(counts[n] == 0 for n in BACKWARD):
        raise AssertionError(f"tiny training step missed a kernel: {counts}")
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    if not loss_err <= 1e-5:
        raise AssertionError(f"tiny losses card {got} vs CPU {want}")
    tol = grad_tolerances(g_cpu)
    grad_err = {n: float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()}
    bad = [n for n in g_cpu if not grad_err[n] <= tol[n]]
    if bad:
        raise AssertionError(f"tiny gradients card vs CPU: "
                             f"{[(n, grad_err[n], tol[n]) for n in bad[:5]]}")
    tcfg = TrainerConfig(optim=optim)
    t_cpu, t_gpu = Trainer(cpu, tcfg, "cpu"), Trainer(gpu, tcfg, "cuda")
    x0 = [x.detach().clone() for x in t_cpu.optimizer.masters]
    m_cpu = t_cpu.train_step(batch, [draws])
    m_gpu = t_gpu.train_step(to_dev(batch, "cuda"), [to_dev(draws, "cuda")])
    gn_err = abs(m_gpu["grad_norm"] - m_cpu["grad_norm"]) / m_cpu["grad_norm"]
    if not gn_err <= 1e-5:
        raise AssertionError(f"tiny grad norm card {m_gpu['grad_norm']} vs "
                             f"CPU {m_cpu['grad_norm']}")
    adam = adamw_check(t_cpu.optimizer, t_gpu.optimizer, x0)
    return dict(losses_cpu=want, losses_card=got, loss_max_rel_err=loss_err,
                grad_max_abs_err=max(grad_err.values()),
                grad_max_err_over_tol=max(grad_err[n] / tol[n]
                                          for n in g_cpu),
                grad_norm_rel_err=gn_err, metrics_cpu=m_cpu,
                metrics_card=m_gpu, launches=counts, **adam)


def adamw_check(opt_cpu, opt_gpu, x0) -> dict:
    """One AdamW step on the card against the CPU from the same masters
    ``x0``: (1) the moments m and v within `grad_tolerances` of each leaf's
    (they are the clipped gradients, scaled and squared); (2) the card's
    update equal to AdamW's formula in fp64 from the card's own moments,
    within 2 fp32 ulps of the master plus 1e-6 of the step (a flipped sign,
    a wrong bias correction, lr or weight decay moves a master by far more).
    The update's difference from the CPU's, over the norm of the CPU's, is
    reported and not checked: a leaf whose exact gradient vanishes (a key
    bias before a softmax) holds rounding noise, and Adam turns noise into
    steps of +-lr with the noise's sign."""
    c = opt_cpu.cfg
    names = opt_cpu.names
    for key in ("m", "v"):
        want = dict(zip(names, getattr(opt_cpu, key)))
        tol = grad_tolerances(want)
        got = {n: x.cpu() for n, x in zip(names, getattr(opt_gpu, key))}
        bad = [(n, float((got[n] - w).abs().max()), tol[n])
               for n, w in want.items()
               if not float((got[n] - w).abs().max()) <= tol[n]]
        if bad:
            raise AssertionError(f"tiny AdamW {key} card vs CPU: {bad[:5]}")
    lr = opt_cpu.schedule(0)
    bc1, bc2 = 1.0 - c.beta1, 1.0 - c.beta2
    arith, diff2, norm2 = 0.0, 0.0, 0.0
    for i, n in enumerate(names):
        scale, wd = opt_gpu.group_of[i]
        wd = c.weight_decay if wd is None else wd
        x = x0[i].double()
        m, v = opt_gpu.m[i].cpu().double(), opt_gpu.v[i].cpu().double()
        u = (m / bc1) / ((v / bc2).sqrt() + c.eps) + wd * x
        want = x - lr * scale * u
        got = opt_gpu.masters[i].cpu().double()
        tol = (2.0 ** -22 * float(want.abs().max())
               + 1e-6 * lr * scale * float(u.abs().max()))
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"tiny AdamW update of {n} on the card: "
                                 f"{err} from the formula > {tol}")
        arith = max(arith, err / tol)
        d_cpu = opt_cpu.masters[i].double() - x
        diff2 += float((got - x - d_cpu).pow(2).sum())
        norm2 += float(d_cpu.pow(2).sum())
    return dict(adamw_lr=lr, adamw_max_err_over_tol=arith,
                update_rel_diff_vs_cpu=(diff2 / norm2) ** 0.5)


# --------------------------------------------------------------------------
# the flagship slices


def prompt_inputs(cfg, device):
    import torch

    s = cfg.special
    rng = np.random.RandomState(SEED)
    ids, att = make_prompt(s, rng, cfg.num_img_token)
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    size = cfg.visual.encoder.vit.image_size
    images = torch.rand((B, N_IMG, size, size, 3), generator=g,
                        device=device)
    n_img = torch.full((B,), N_IMG, dtype=torch.int64, device=device)
    return (torch.from_numpy(ids).to(device), images, n_img,
            torch.from_numpy(att).to(device))


def run_text_slice(model, device: str, cases) -> dict:
    """`generate_texts` through the model: a capturing warm-up, a 1-token
    run (prefill time), the counted 32-token run and a second one; then a
    prefill whose logits are checked.  Raises on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.llama import KVCache

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)
    gen = TextGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=(),
                               pad_token_id=cfg.special.pad_token_id)

    def run(new_tokens):
        c = dataclasses.replace(gen, max_new_tokens=new_tokens)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate_texts(model, ids, images, n_img, att, c)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    with capture(["ms_deform_attn_fwd"], cases):  # warm-up, real inputs
        run(2)
    check_sites("ms_deform_attn_fwd", cases)
    _, prefill_ms = run(1)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tokens, gen_ms = run(NEW_TOKENS)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens2, _ = run(NEW_TOKENS)

    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    expected = (2 * adapter.num_interactions + adapter.extra_extractors
                + n_cross * NEW_TOKENS)
    if launches["ms_deform_attn_fwd"] != expected:
        raise AssertionError(f"kernel 1 launches "
                             f"{launches['ms_deform_attn_fwd']} != {expected}")
    if launches["flash_attention_fwd"] != encoder_flash_calls(cfg):
        raise AssertionError(f"text slice flash launches "
                             f"{launches['flash_attention_fwd']} != "
                             f"{encoder_flash_calls(cfg)}")
    if tuple(tokens.shape) != (B, NEW_TOKENS):
        raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
    if not ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all():
        raise AssertionError("tokens out of vocabulary")
    if not torch.equal(tokens, tokens2):
        raise AssertionError("two greedy runs differ")
    with torch.inference_mode():
        prep = model.prepare_mm_embeds(ids, images, n_img)
        cache = KVCache.create(cfg.llm, B, PROMPT_LEN, device=device,
                               dtype=model.soi_token.dtype)
        logits = model.lm_prefill(prep["mm_embeds"], att, prep["mmfs_values"],
                                  prep["cross_attention_mask"], cache)[0]
    if tuple(logits.shape) != (B, PROMPT_LEN, cfg.llm.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    return dict(tokens=tokens, launches=launches, prefill_ms=prefill_ms,
                gen_ms=gen_ms,
                decode_ms=(gen_ms - prefill_ms) / (NEW_TOKENS - 1),
                peak_gb=peak_gb)


def encoder_flash_calls(cfg) -> int:
    """Mask-free attention calls of one visual-tokenizer pass: the ViT's
    layers, the Q-Former's self-attentions and its cross-attentions."""
    p = cfg.visual.perceiver
    return (cfg.visual.encoder.vit.num_hidden_layers + p.num_hidden_layers
            + len(range(0, p.num_hidden_layers, p.cross_attention_frequency)))


def unet_gn_calls(u, batch: int) -> list:
    """``(batch, px, C, silu)`` of each GroupNorm call of one UNet forward,
    in order: each ResnetBlock's two norms (with SiLU), each
    SpatialTransformer's (without), the output norm (with), as
    `UNet2DConditionModel` builds them."""
    chans, n, lpb = u.block_out_channels, len(u.block_out_channels), \
        u.layers_per_block
    px, ch, skips, calls = u.sample_size, chans[0], [chans[0]], []

    def res(cin, cout):
        calls.extend([(batch, px, cin, True), (batch, px, cout, True)])

    for i, out in enumerate(chans):
        for _ in range(lpb):
            res(ch, out)
            ch = out
            if i != n - 1:
                calls.append((batch, px, ch, False))
            skips.append(ch)
        if i != n - 1:
            px //= 2
            skips.append(ch)
    res(ch, ch)
    calls.append((batch, px, ch, False))
    res(ch, ch)
    for i, out in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            res(ch + skips.pop(), out)
            ch = out
            if i != 0:
                calls.append((batch, px, ch, False))
        if i != n - 1:
            px *= 2
    calls.append((batch, px, ch, True))
    return calls


def vae_gn_calls(v, batch: int, size: int, encoder: bool) -> list:
    """``(batch, px, C, silu)`` of each GroupNorm call of the VAE's encoder
    (``size``: the image's) or decoder (the latents'), as `sd/vae.py`
    builds them: each ResnetBlock's two norms, the mid attention's, the
    output norm."""
    chans, n, lpb = v.block_out_channels, len(v.block_out_channels), \
        v.layers_per_block
    calls = []

    def res(px, cin, cout):
        calls.extend([(batch, px, cin, True), (batch, px, cout, True)])

    def mid(px, ch):
        res(px, ch, ch)
        calls.append((batch, px, ch, False))
        res(px, ch, ch)

    if encoder:
        px, ch = size, chans[0]
        for i, out in enumerate(chans):
            for _ in range(lpb):
                res(px, ch, out)
                ch = out
            if i != n - 1:
                px //= 2
        mid(px, ch)
    else:
        px, ch = size, chans[-1]
        mid(px, ch)
        for i, out in enumerate(reversed(chans)):
            for _ in range(lpb + 1):
                res(px, ch, out)
                ch = out
            if i != n - 1:
                px *= 2
    calls.append((batch, px, ch, True))
    return calls


def _chunks(batch: int, mini: int) -> int:
    return batch // mini if 0 < mini < batch and batch % mini == 0 else 1


def image_gn_calls(cfg, rows: int) -> tuple:
    """(the GroupNorm calls of one denoise step, of the VAE decode) of
    `generate_images` over ``rows`` image rows with CFG."""
    idc = cfg.image_decoder
    chunks = _chunks(rows, idc.vae_decode_mini_bs)
    return (unet_gn_calls(idc.unet, 2 * rows),
            vae_gn_calls(idc.vae, rows // chunks, idc.latent_size, False)
            * chunks)


def gn_site_keys(cfg, rows: int) -> list:
    """The distinct GroupNorm call shapes of the image path."""
    step, vae = image_gn_calls(cfg, rows)
    return sorted({gn_key(*c) for c in step + vae})


def expected_image_launches(cfg, steps: int, rows: int) -> dict:
    """Each kernel's launches for `generate_image_inputs` + one
    `generate_images` call, derived from the config."""
    idc = cfg.image_decoder
    u = idc.unet
    lpb = u.layers_per_block
    # SpatialTransformer widths: every down block but the last, the mid
    # block, every up block but the first
    widths = ([ch for ch in u.block_out_channels[:-1] for _ in range(lpb)]
              + [u.block_out_channels[-1]]
              + [ch for ch in reversed(u.block_out_channels[:-1])
                 for _ in range(lpb + 1)])
    geglu_blocks = sum(1 for ch in widths if ch <= 640)
    mmfs_blocks = len(u.down_residual_spec()[0]) + 1
    step_gn, vae_gn = image_gn_calls(cfg, rows)
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    adapter = cfg.visual.encoder
    return {
        "ms_deform_attn_fwd": (2 * adapter.num_interactions
                               + adapter.extra_extractors + n_cross),
        "ms_deform_attn_mi_fwd": mmfs_blocks * steps,
        "flash_attention_fwd": (encoder_flash_calls(cfg)
                                + cfg.llm.num_hidden_layers
                                + idc.perceiver.num_hidden_layers
                                + 2 * len(widths) * steps),
        # each GroupNorm(+SiLU) call: one moments and one apply launch
        **dict.fromkeys(GN, len(step_gn) * steps + len(vae_gn)),
        "geglu_fwd": geglu_blocks * steps,
        # inference records no graph: no backward kernel runs; the
        # benchmark's kernels serve the benchmark alone
        **{name: 0 for name in (*BACKWARD, *BENCH, *V4_BWD, *QUANT)},
    }


def unet_counts(cfg):
    """(SpatialTransformers, MMFS blocks) of the UNet."""
    u = cfg.image_decoder.unet
    n, lpb = len(u.block_out_channels), u.layers_per_block
    return ((n - 1) * lpb + 1 + (n - 1) * (lpb + 1),
            len(u.down_residual_spec()[0]) + 1)


def expected_train_launches(cfg, images: int) -> dict:
    """Each kernel's launches in one training step (one micro-batch),
    derived from the config.  Every deformable and mask-free attention call
    of the step needs its backward (the adapter, the Q-Former, the LLM's
    MMFS and the UNet train, and each feeds the calls after it); remat
    runs the forward of each remat'd LLM layer and UNet block again in the
    backward; the VAE encodes without gradient; the fused GEGLU and the
    factorised MMFS kernel serve inference alone."""
    idc = cfg.image_decoder
    transformers, mmfs_blocks = unet_counts(cfg)
    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    llm_r = 2 if cfg.llm.remat else 1
    unet_r = 2 if idc.unet.remat else 1
    chunks = _chunks(images, idc.vae_encode_mini_bs)
    # the UNet's norms but the output norm sit in its remat'd blocks; the
    # VAE encodes without gradient
    gn = ((len(unet_gn_calls(idc.unet, images)) - 1) * unet_r + 1
          + len(vae_gn_calls(idc.vae, images // chunks, idc.image_size,
                             True)) * chunks)
    deform = 2 * adapter.num_interactions + adapter.extra_extractors \
        + n_cross + mmfs_blocks
    flash = (encoder_flash_calls(cfg) + cfg.llm.num_hidden_layers
             + idc.perceiver.num_hidden_layers + 2 * transformers)
    return {
        "ms_deform_attn_fwd": deform + (llm_r - 1) * n_cross,
        "ms_deform_attn_mi_fwd": 0,
        "flash_attention_fwd": flash
        + (llm_r - 1) * cfg.llm.num_hidden_layers
        + (unet_r - 1) * 2 * transformers,
        **dict.fromkeys(GN, gn),
        "geglu_fwd": 0,
        "ms_deform_attn_bwd_value": deform,
        "ms_deform_attn_bwd_loc_weight": deform,
        "flash_attention_bwd": flash,
        **{name: 0 for name in (*BENCH, *V4_BWD, *QUANT)},
    }


def run_image_slice(model, device: str, cases) -> dict:
    """`generate_image_inputs` + `generate_images` on the text slice's
    prompt: a capturing 2-step warm-up, the counted 25-step run and a
    second one (bit-identical), and two 2-step runs with and without the
    MMFS values.  Raises on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.generation.diffusion import generate_images

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)

    def run(steps, zero_mmfs=False):
        g = torch.Generator(device=device)
        g.manual_seed(SEED + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inp = model.generate_image_inputs(ids, images, n_img, att)
        ctx, ctx_mask, values, mask = inp
        rows = torch.arange(B * cfg.max_num_images, device=device)
        rows = rows[(rows % cfg.max_num_images) < N_IMG]  # the target slots
        ctx, ctx_mask, values, mask = (x[rows] for x in inp)
        if zero_mmfs:
            values = torch.zeros_like(values)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = generate_images(model, ctx, ctx_mask, values, mask,
                              num_inference_steps=steps,
                              guidance_scale=GUIDANCE, generator=g)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return out, mask, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    rows = B * N_IMG
    with capture([k for k in FORWARD if k not in ("ms_deform_attn_fwd", *GN)]
                 + ["group_norm"], cases):
        run(2)
    for name in FORWARD:
        if name not in GN:
            check_sites(name, cases)
    want = sorted(gn_site_keys(cfg, rows) + [TINY])
    if sorted(cases["group_norm"]) != want:
        raise AssertionError(f"group_norm: captured sites "
                             f"{sorted(cases['group_norm'])} != {want}")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    images1, mask, inputs_ms, gen_ms = run(IMG_STEPS)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_image_launches(cfg, IMG_STEPS, rows)
    if launches != expected:
        raise AssertionError(f"image slice launches {launches} != "
                             f"{expected}")
    size = cfg.image_decoder.image_size
    if tuple(images1.shape) != (B * N_IMG, size, size, 3):
        raise AssertionError(f"images shape {tuple(images1.shape)}")
    if not torch.isfinite(images1).all():
        raise AssertionError("non-finite images")
    if float(images1.min()) < 0.0 or float(images1.max()) > 1.0:
        raise AssertionError("images outside [0, 1]")
    images2, _, _, _ = run(IMG_STEPS)
    if not torch.equal(images1, images2):
        raise AssertionError("two seeded image runs differ")
    live = mask[:, 0].bool()
    if int(live.sum()) != B * (N_IMG - 1):
        raise AssertionError(f"mmfs_mask {mask.flatten().tolist()}")
    with_mmfs, _, _, _ = run(2)
    without, _, _, _ = run(2, zero_mmfs=True)
    moved = (with_mmfs - without).abs().amax(dim=(1, 2, 3))
    if not bool((moved[live] > 0).all()):
        raise AssertionError(f"MMFS values do not reach the live rows: "
                             f"{moved.tolist()}")

    # one step's breakdown: the decode alone
    dec = model.image_decoder
    z = torch.randn((rows, cfg.image_decoder.latent_size,
                     cfg.image_decoder.latent_size, 4), device=device)
    with torch.inference_mode():
        vae_ms = time_ms(lambda: dec.vae_decode(z), runs=3)
    return dict(launches=launches, expected=expected, inputs_ms=inputs_ms,
                generate_ms=gen_ms,
                step_ms=(gen_ms - vae_ms) / IMG_STEPS, vae_decode_ms=vae_ms,
                total_ms=inputs_ms + gen_ms, peak_gb=peak_gb,
                mmfs_moved=moved.tolist(),
                image_mean=float(images1.mean()))


def profile_step(model, device: str) -> dict:
    """Device time by kernel over one denoise step (torch.profiler): the
    difference of a 2-step and a 1-step `generate_images` run."""
    import torch

    from mm_interleaved_tpu_torch.generation.diffusion import generate_images

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, device)
    inp = model.generate_image_inputs(ids, images, n_img, att)
    rows = torch.arange(B * cfg.max_num_images, device=device)
    rows = rows[(rows % cfg.max_num_images) < N_IMG]
    inp = [x[rows] for x in inp]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    per_kernel, launches = {}, [0, 0]
    for steps in (1, 2):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            generate_images(model, *inp, num_inference_steps=steps,
                            guidance_scale=GUIDANCE, generator=g)
            torch.cuda.synchronize()
        for key, (ms, n) in device_kernels(prof).items():
            per_kernel.setdefault(key, [0.0, 0.0])[steps - 1] += ms
            launches[steps - 1] += n
    step = sorted(((k, v[1] - v[0]) for k, v in per_kernel.items()),
                  key=lambda kv: -kv[1])
    return dict(device_ms=sum(ms for _, ms in step),
                launches=launches[1] - launches[0],
                top=[dict(kernel=k[:80], ms=round(ms, 3))
                     for k, ms in step[:12]])


# --------------------------------------------------------------------------
# the flagship training step


def train_inputs(cfg, device):
    """The phase 5-6 prompt as a training batch, with the 512 px targets of
    its image decoder."""
    import torch

    ids, images, n_img, att = prompt_inputs(cfg, device)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 3)
    size = cfg.image_decoder.image_size
    dec = torch.rand((B, N_IMG, size, size, 3), generator=g, device=device)
    return dict(text_ids=ids, image_tensors=images, num_image_per_seq=n_img,
                attention_mask=att, image_tensors_dec=dec)


def run_training(device: str, cases) -> dict:
    """The flagship's training form, 3 AdamW steps on the prompt: step 1
    twice from one state (the first capturing the backward kernels'
    inputs), then steps 2 and 3, the last under `torch.profiler`.  Raises
    on any failed check."""
    import torch

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = flagship_config(max_num_images=N_IMG)
    optim = OptimConfig(warmup_steps=0)
    held_gb = torch.cuda.memory_allocated() / 1e9  # earlier phases' inputs
    t0 = time.perf_counter()
    model = build_model(cfg, device, torch.bfloat16, seed=SEED, optim=optim)
    perturb_zero_inits(model, SEED + 1)
    trainer = Trainer(model, TrainerConfig(optim=optim), device)
    opt = trainer.optimizer
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    frozen = {n: p.detach().to("cpu", copy=True) for n, p in params.items()
              if not p.requires_grad}
    start = [p.detach().to("cpu", copy=True) for p in opt.params]
    n_train = sum(p.numel() for p in opt.params)
    log(f"flagship training form: {n_train / 1e9:.3f} B trainable (fp32 "
        f"masters), {sum(t.numel() for t in frozen.values()) / 1e9:.3f} B "
        f"frozen, bf16 compute, remat llm={cfg.llm.remat} "
        f"unet={cfg.image_decoder.unet.remat}, built in {build_s:.1f} s")
    batch = train_inputs(cfg, device)

    def step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        return m, (time.perf_counter() - t) * 1e3

    torch.cuda.reset_peak_memory_stats()
    with capture(list(BACKWARD), cases):
        m_first, _ = step()
    for name in BACKWARD:
        check_sites(name, cases)
    first = [x.detach().to("cpu", copy=True) for x in opt.masters]
    # back to the starting state: zero moments and count; the masters were
    # the bf16 parameters made fp32
    with torch.no_grad():
        for p, x0, x, m, v in zip(opt.params, start, opt.masters, opt.m,
                                  opt.v):
            p.copy_(x0)
            x.copy_(x0)
            m.zero_()
            v.zero_()
    opt.count, trainer.step = 0, 0
    reset_counts()
    m1, ms1 = step()
    launches = read_counts()
    images = B * N_IMG
    expected = expected_train_launches(cfg, images)
    if launches != expected:
        raise AssertionError(f"training launches {launches} != {expected}")
    # the two runs of step 1: the same bits (every kernel sums in a fixed
    # order)
    same = dict(loss=m1["loss"] == m_first["loss"],
                grad_norm=m1["grad_norm"] == m_first["grad_norm"],
                masters=all(torch.equal(x.cpu(), x1)
                            for x, x1 in zip(opt.masters, first)))
    if not all(same.values()):
        differ = [lab for lab, x, x1 in zip(opt.labels, opt.masters, first)
                  if not torch.equal(x.cpu(), x1)]
        raise AssertionError(
            f"two runs of step 1 differ: {same}; loss {m_first['loss']!r} / "
            f"{m1['loss']!r}, grad norm {m_first['grad_norm']!r} / "
            f"{m1['grad_norm']!r}; masters of groups {sorted(set(differ))}")
    m2, ms2 = step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        m3, ms3 = step()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = [m1, m2, m3]
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training metrics {m}")
    for n, t in frozen.items():
        if not torch.equal(params[n].detach(), t.to(device)):
            raise AssertionError(f"frozen parameter {n} changed")
    moved = {}  # by the fp32 masters: a bf16 weight moves by whole ulps
    for lab, x, x0 in zip(opt.labels, opt.masters, start):
        d = float((x - x0.to(device).float()).abs().max())
        moved[lab] = max(moved.get(lab, 0.0), d)
    if not all(d > 0 for d in moved.values()):
        raise AssertionError(f"a trainable group did not move: {moved}")
    by_kernel = device_kernels(prof)
    per_kernel = {k: ms for k, (ms, _) in by_kernel.items()}
    n_launch = sum(n for _, n in by_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    device_ms = sum(per_kernel.values())
    del model, trainer, opt, params
    torch.cuda.empty_cache()
    return dict(metrics=metrics, step_ms=[ms1, ms2, ms3],
                first_run=m_first, step1_same=same, launches=launches,
                expected=expected,
                peak_gb=peak_gb, held_gb=held_gb, moved=moved,
                trainable=n_train,
                device_ms=device_ms, busy=device_ms / ms2,
                profiled_launches=n_launch,
                top=[dict(kernel=k[:80], ms=round(v, 3)) for k, v in top[:14]])


# --------------------------------------------------------------------------
# each kernel against its plain version


def _bound(flops, nbytes, rate):
    """(ops ms, bytes ms): the least times for the operations at the
    peak rate of their type and for the bytes at the memory rate."""
    return flops / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def work_deform(args, kw, out):
    """Bytes: the value texels the samples can touch (at most 4 corners of
    D channels per sample, at most the whole value), the locations, the
    weights and the output; operations: 4 FMAs per sample and channel (the
    attention weight folds into the corner weights once per sample)."""
    value, shapes, loc, w = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return 8 * samples * D, touched + _nbytes(loc, w, out), PEAK_FP32_FLOPS


def work_flash(args, kw, out):
    import torch

    q, k, v = args
    B_, Tq, H, D = q.shape
    Tk = k.shape[1]
    pairs = B_ * Tq * Tk
    if kw.get("causal") or kw.get("q_segment_ids") is not None:
        dev = q.device
        ok = torch.ones((B_, Tq, Tk), dtype=torch.bool, device=dev)
        if kw.get("causal"):
            qi = torch.arange(Tq, device=dev)[:, None] + (Tk - Tq)
            ok &= (torch.arange(Tk, device=dev)[None, :] <= qi)[None]
        if kw.get("q_segment_ids") is not None:
            ok &= (kw["q_segment_ids"][:, :, None]
                   == kw["kv_segment_ids"][:, None, :])
        pairs = int(ok.sum())
    flops = 4 * pairs * H * D
    return flops, _nbytes(q, k, v, out), PEAK_BF16_FLOPS


def work_mi(args, kw, out):
    from mm_interleaved_tpu_torch.bench_unet_kernels import mi_work

    return mi_work(args, out)


def work_geglu(args, kw, out):
    from mm_interleaved_tpu_torch.bench_unet_kernels import geglu_work

    return geglu_work(args, out)


WORK = {
    "ms_deform_attn_fwd": work_deform,
    "ms_deform_attn_mi_fwd": work_mi,
    "flash_attention_fwd": work_flash,
    "geglu_fwd": work_geglu,
}
# kernels whose sites are also timed as device time under torch.profiler
# and back to back (phase 7)
DEVICE_TIMED = ("flash_attention_fwd", "ms_deform_attn_mi_fwd", "geglu_fwd",
                "ms_deform_attn_fwd")


def _geglu_variant(args):
    from mm_interleaved_tpu_torch.ops.geglu import geglu_variant

    x, w1, b1, w2, b2 = args
    return geglu_variant(x.shape[-1], w2.shape[1], x.dtype)


def _mi_variant(args):
    from mm_interleaved_tpu_torch.ops.ms_deform_attn_mi import mi_variant

    return mi_variant(args[0].shape[-1], args[0].dtype)


# the variant each site's bf16 call takes, logged beside it
VARIANT_OF = {"geglu_fwd": _geglu_variant,
              "ms_deform_attn_mi_fwd": _mi_variant}
# positional arguments that take the compared dtype (the rest stay as
# captured: fp32 tables, shapes, segment ids, scalars)
CAST = {
    "ms_deform_attn_fwd": (0, 2, 3),
    "ms_deform_attn_mi_fwd": (0, 5),
    "flash_attention_fwd": (0, 1, 2),
    "geglu_fwd": (0, 1, 2, 3, 4),
}


def sdpa_call(args, kw, transposed=False):
    """One `scaled_dot_product_attention` call computing the same function
    (the yardstick; the port never calls it); ``args`` are ``[B, T, H,
    D]``, or ``[B, H, T, D]`` when ``transposed``."""
    import torch.nn.functional as F

    q, k, v = (args[:3] if transposed
               else (a.transpose(1, 2) for a in args[:3]))
    mask = None
    if kw.get("causal") or kw.get("q_segment_ids") is not None:
        # the helper takes [B, T, H, D]
        mask = attention_allowed(q.transpose(1, 2), k.transpose(1, 2),
                                 kw.get("causal", False),
                                 kw.get("q_segment_ids"),
                                 kw.get("kv_segment_ids"))
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=kw.get("scale"))


def compare_kernel(name, sites_cases, sites=None) -> dict:
    """The kernel against its plain version on each captured call (of
    ``sites``, by default every site the path must have), in bf16
    and fp32, both timed; the bound of each call from its inputs.  The
    kernels of `DEVICE_TIMED` are also read as device time and back to
    back; GEGLU beside the unfused path of the C = 1280 blocks
    (``unfused_ms``), the MMFS readout with the spread of its sampling
    offsets logged."""
    import torch

    from mm_interleaved_tpu_torch import bench_unet_kernels as bench

    mod = kmod(name)
    kernel = getattr(mod, KERNELS[name]["kernel"])
    plain = getattr(mod, KERNELS[name]["plain"])
    recs = []
    for site in sites or WANT_SITES[name]:
        args, kw = sites_cases[site]
        rec = dict(site=site, shapes=[list(a.shape) for a in args
                                      if isinstance(a, torch.Tensor)])
        if name in VARIANT_OF:
            rec["variant"] = VARIANT_OF[name](args)
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = tuple(x.to(dt) if i in CAST[name] else x
                      for i, x in enumerate(args))
            with torch.inference_mode():
                got = kernel(*a, **kw)
                want = plain(*a, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                if tag == "fp32":
                    # the same sums in another order; the GEGLU products
                    # reduce over K up to 2560
                    rel = 1e-4 if name == "geglu_fwd" else 1e-5
                    tol = rel * max(scale, 1.0)
                else:  # one bf16 ulp at the output's scale
                    tol = _ulps(scale)
                if not err <= tol:
                    raise AssertionError(f"{name} {site} {tag}: kernel vs "
                                         f"plain {err} > {tol}")
                rec[f"max_abs_err_{tag}"] = err
                rec[f"tol_{tag}"] = tol
                rec[f"scale_{tag}"] = scale
                rec[f"ms_{tag}"] = time_ms(lambda: kernel(*a, **kw))
                rec[f"plain_ms_{tag}"] = time_ms(lambda: plain(*a, **kw))
                if tag == "bf16":
                    flops, nbytes, rate = WORK[name](a, kw, got)
                    rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes,
                                                            rate)
                    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                    rec["bound_by"] = ("operations" if rec["ops_ms"]
                                       > rec["bytes_ms"] else "bytes")
                    rec["flops"], rec["bytes"] = flops, nbytes
                    rec["library_ms"] = (time_ms(sdpa_call(a, kw))
                                         if name == "flash_attention_fwd"
                                         else None)
                    if name in DEVICE_TIMED:
                        rec["device_ms"] = device_ms(lambda: kernel(*a, **kw))
                        rec["queued_ms"] = queued_ms(lambda: kernel(*a, **kw))
                    if name == "flash_attention_fwd":
                        lib = sdpa_call(a, kw)
                        rec["library_device_ms"] = device_ms(lib)
                        rec["library_queued_ms"] = queued_ms(lib)
                    if name == "geglu_fwd" and site != TINY:
                        # the C = 1280 blocks' unfused path, a yardstick
                        # the port never calls at these widths
                        rec["unfused_ms"] = time_ms(
                            lambda: bench.unfused_geglu(*a))
                    if name == "ms_deform_attn_mi_fwd" and site != TINY:
                        log(f"offset spread in texels, {name} {site}: "
                            + json.dumps(bench.offset_spread(a)))
                        # one exp per unmasked (query, key) pair and head at
                        # the assumed SFU rate: computed, not measured, so
                        # logged on its own line and kept out of the record
                        log(f"exp ceiling, {name} {site}: "
                            + json.dumps(dict(exp_ceiling_ms=flops / (
                                4 * a[0].shape[-1]) / PEAK_EXPS * 1e3)))
            del got, want
        recs.append(rec)
        log(f"kernel vs plain, {name} {site}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    return recs


def work_deform_bwd_value(args, kw, out):
    """Bytes: dOut, the locations and weights read, the value gradient
    written once; operations: 8 per sample and channel (the corner weights
    times w * dOut, and the four adds)."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    samples = N * Q * H * L * P
    return (8 * samples * value.shape[3],
            _nbytes(grad_out, loc, w, value), PEAK_FP32_FLOPS)


def work_deform_bwd_loc_weight(args, kw, out):
    """Bytes: the corners the samples can touch (as `work_deform`), dOut,
    the locations and weights read, their gradients written; operations: 8
    per sample and channel (the four corner dot products)."""
    value, shapes, loc, w, grad_out = args
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    touched = min(value.numel(), 4 * samples * D) * value.element_size()
    return (8 * samples * D, touched + _nbytes(grad_out, loc, w, *out),
            PEAK_FP32_FLOPS)


def work_flash_bwd(args, kw, out):
    """Operations: 10 per unmasked (query, key) pair, head and channel (the
    recomputed S, dP, and the dV, dK, dQ products); bytes: q, k, v, dOut
    and the LSE read, dq, dk, dv written."""
    q, k, v, grad_out, lse = args
    flops, _, rate = work_flash((q, k, v), kw, q)
    return flops // 4 * 10, _nbytes(q, k, v, grad_out, lse, *out), rate


WORK.update({
    "ms_deform_attn_bwd_value": work_deform_bwd_value,
    "ms_deform_attn_bwd_loc_weight": work_deform_bwd_loc_weight,
    "flash_attention_bwd": work_flash_bwd,
    # the same functions in the v4 formulation: the same work
    "ms_deform_attn_v4_bwd_value": work_deform_bwd_value,
    "ms_deform_attn_v4_bwd_loc_weight": work_deform_bwd_loc_weight,
})


def _backward_case(name, args, kw, dt):
    """The captured inputs in ``dt`` (flash attention's LSE recomputed by
    the forward kernel from the cast q, k, v), the number of them the plain
    forward takes, the positions the gradient is taken for, that plain
    forward, and the training forward's outputs (flash attention; else
    None)."""
    import torch

    from mm_interleaved_tpu_torch.ops import flash_attention as fa
    from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk

    if name == "flash_attention_bwd":
        q, k, v, grad_out, _ = args
        q, k, v, grad_out = (x.to(dt) for x in (q, k, v, grad_out))
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        return ((q, k, v, grad_out, lse), 3, (0, 1, 2),
                lambda *x: fa.attention_plain(*x, **kw),
                dict(out=out, lse=lse))
    value, shapes, loc, w, grad_out = args
    value, loc, w, grad_out = (x.to(dt) for x in (value, loc, w, grad_out))
    wrt = (0,) if name == "ms_deform_attn_bwd_value" else (2, 3)
    return ((value, shapes, loc, w, grad_out), 4, wrt,
            dk.ms_deform_attn_plain, None)


def _grad_timer(fn, a, wrt, grad_out):
    """One backward through ``fn``'s graph on ``a`` (built once)."""
    import torch

    with torch.enable_grad():
        ins = [x.detach().requires_grad_(i in wrt) if hasattr(x, "detach")
               else x for i, x in enumerate(a)]
        out = fn(*ins)
    wanted = [ins[i] for i in wrt]
    return lambda: torch.autograd.grad(out, wanted, grad_out,
                                       retain_graph=True)


def sdpa_grad_timer(a, kw):
    """Autograd through `scaled_dot_product_attention` on the same inputs
    (the yardstick; the port never calls it)."""
    import torch

    q, k, v, grad_out, _ = a
    ins = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    with torch.enable_grad():
        out = sdpa_call(ins, kw, transposed=True)()
    return lambda: torch.autograd.grad(out, ins, grad_out.transpose(1, 2),
                                       retain_graph=True)


def attention_allowed(q, k, causal=False, q_segment_ids=None,
                      kv_segment_ids=None):
    """The pairs a query may attend to, ``[B, 1, Tq, Tk]`` bool, or None."""
    import torch

    tq, tk = q.shape[1], k.shape[1]
    ok = torch.ones((q.shape[0], 1, tq, tk), dtype=torch.bool,
                    device=q.device)
    if causal:
        qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        ok &= torch.arange(tk, device=q.device)[None, :] <= qi
    if q_segment_ids is not None:
        ok &= (q_segment_ids[:, None, :, None]
               == kv_segment_ids[:, None, None, :])
    return ok


def attention_f64(q, k, v, causal=False, scale=None, q_segment_ids=None,
                  kv_segment_ids=None, with_lse=False):
    """Attention in the inputs' dtype throughout (fp64 for the reference
    of the flash backward), with the plain version's masks; with
    ``with_lse`` also the log-sum-exp ``[B, H, Tq]`` of the scaled logits."""
    import torch

    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    ok = attention_allowed(q, k, causal, q_segment_ids, kv_segment_ids)
    logits = logits.masked_fill(~ok, torch.finfo(torch.float32).min)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return (out, torch.logsumexp(logits, dim=-1)) if with_lse else out


def check_training_forward(a, kw, fwd, tag, fails) -> dict:
    """The training forward's outputs (the forward kernel that also writes
    the LSE) against attention in fp64 on the same inputs; a miss is
    appended to ``fails``.  The output within one bf16 ulp at its scale
    (bf16) or 1e-5 of the largest |v| (at least 1; fp32); the LSE within
    1e-5 of its largest magnitude (at least 1); a row whose keys are all
    masked carries -FLT_MAX there and in the reference's lowest-finite
    fill."""
    import torch

    q, k, v = (x.double() for x in a[:3])
    out_ref, lse_ref = attention_f64(q, k, v, with_lse=True, **kw)
    scale = float(out_ref.abs().max())
    tol = (_ulps(scale) if tag == "bf16"
           else 1e-5 * max(float(v.abs().max()), 1.0))
    dead = lse_ref < -1e30
    lse = fwd["lse"].double()
    if not torch.equal(dead, lse < -1e30):
        fails.append(f"flash training forward {tag}: fully masked rows "
                     "differ")
    lse_ref = lse_ref.masked_fill(dead, 0.0)
    checks = [("out", fwd["out"], out_ref, tol),
              ("lse", lse.masked_fill(dead, 0.0), lse_ref,
               1e-5 * max(float(lse_ref.abs().max()), 1.0))]
    res = {}
    for key, t, ref, tol in checks:
        err = float((t.double() - ref).abs().max())
        if not err <= tol:
            fails.append(f"flash training forward {tag} {key}: {err} > {tol}")
        res[key], res[f"{key}_tol"] = err, tol
    return res


def delta_reading(a, kw, out, dq_ref) -> dict:
    """Why delta comes from P and dP: dQ recomputed in fp32 torch from the
    kernels' own LSE, with P = exp(S * scale - LSE) and delta taken as
    FlashAttention-2 takes it, rowsum(dO * O) from the forward's output
    ``out``, or as the kernels take it, sum P dP / sum P; each one's
    largest error against the fp64 dQ, beside how far sum P strays from
    1."""
    import torch

    q, k, v, g, lse = (x.float() for x in a)
    scale = kw.get("scale") or q.shape[-1] ** -0.5
    ok = attention_allowed(q, k, kw.get("causal", False),
                           kw.get("q_segment_ids"), kw.get("kv_segment_ids"))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    p_sum = p.sum(-1)
    live = p_sum > 0
    deltas = dict(from_o=(g * out.float()).sum(-1).permute(0, 2, 1),
                  from_p=(p * dp).sum(-1) / p_sum.clamp_min(1e-30))
    res = dict(p_sum_max_dev=float((p_sum - 1).abs()[live].max()))
    for key, d in deltas.items():
        ds = p * (dp - d[..., None])
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
        res[f"dq_err_delta_{key}"] = float((dq.double() - dq_ref).abs().max())
        del ds, dq
    return res


# Shapes no captured site has, which the Hopper kernels' tiling (128-query
# CTAs, 128-key and 64-row tiles, TMA boxes that read zeros past the end)
# makes risky, and the bf16 mma.sync bodies at the widths they serve (D % 16
# == 0 other than 64 and 128; D = 32 is the small preset's): name: (B, Tq,
# Tk, H, D, causal, segments); "dead" gives the first 7 queries of each row
# a segment no key has, "sorted" draws sorted segments for both sides
FLASH_EDGES = {
    "straddle_cross": (2, 200, 77, 3, 64, False, None),
    "straddle_self_d128": (2, 257, 257, 3, 128, False, None),
    "causal_tq_lt_tk": (2, 100, 300, 2, 64, True, None),
    "dead_segment_rows": (2, 130, 150, 2, 64, False, "dead"),
    "causal_tile_before_keys": (2, 300, 100, 2, 128, True, None),
    "causal_segments_d128": (1, 333, 333, 2, 128, True, "sorted"),
    "mma_straddle_d32": (2, 200, 77, 4, 32, False, None),
    "mma_dead_rows_d32": (2, 130, 150, 2, 32, False, "dead"),
    "mma_causal_segments_d96": (2, 150, 190, 2, 96, True, "sorted"),
}


def flash_edge_case(name, seed):
    """The bf16 q, k, v, dOut on the card and the mask keywords of a
    `FLASH_EDGES` case."""
    import torch

    B_, Tq, Tk, H, D, causal, seg = FLASH_EDGES[name]
    rng = np.random.RandomState(seed)

    def dev(x, dt=torch.bfloat16):
        return torch.tensor(x, dtype=dt, device="cuda")

    q, g = (dev(rng.randn(B_, Tq, H, D)) for _ in range(2))
    k = dev(rng.randn(B_, Tk, H, D) + 0.5)  # a common component, as the ViT's
    v = dev(rng.randn(B_, Tk, H, D))
    kw = dict(causal=causal) if causal else {}
    if seg:
        qs = np.sort(rng.randint(0, 3, (B_, Tq)), 1)
        ks = np.sort(rng.randint(0, 3, (B_, Tk)), 1)
        if seg == "dead":
            qs[:, :7] = 9
        kw.update(q_segment_ids=dev(qs, torch.int32),
                  kv_segment_ids=dev(ks, torch.int32))
    return (q, k, v, g), kw


def check_flash_edges(backward: bool) -> list:
    """Each `FLASH_EDGES` case in bf16 with the tolerances of the captured
    sites: the forward within one bf16 ulp of its plain version and, with
    its LSE, `check_training_forward` against fp64 attention; the backward
    (``backward``) within the larger of 4 bf16 ulps and 4x the plain
    version's own error of fp64 autograd, and bit-identical over two runs.
    Every failure is gathered; the phase fails after the last case."""
    import torch

    from mm_interleaved_tpu_torch.ops import flash_attention as fa

    recs, fails = [], []
    for i, name in enumerate(FLASH_EDGES):
        (q, k, v, g), kw = flash_edge_case(name, SEED + 100 + i)
        rec = dict(case=name, shape=list(FLASH_EDGES[name]))
        with torch.no_grad():
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            want = fa.attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        rec["fwd_err"] = float((out.float() - want.float()).abs().max())
        rec["fwd_tol"] = _ulps(scale)
        if not rec["fwd_err"] <= rec["fwd_tol"]:
            fails.append(f"flash edge {name} forward: {rec['fwd_err']} > "
                         f"{rec['fwd_tol']}")
        rec["training_forward"] = check_training_forward(
            (q, k, v), kw, dict(out=out, lse=lse), "bf16", fails)
        if backward:
            got = fa.flash_attention_bwd(q, k, v, g, lse, **kw)
            again = fa.flash_attention_bwd(q, k, v, g, lse, **kw)
            rec["bit_identical"] = all(torch.equal(a, b)
                                       for a, b in zip(got, again))
            if not rec["bit_identical"]:
                fails.append(f"flash edge {name} backward: two runs differ")
            with torch.enable_grad():
                ins = [x.detach().double().requires_grad_() for x in
                       (q, k, v)]
                ref = torch.autograd.grad(attention_f64(*ins, **kw), ins,
                                          g.double())
            plain = fa.attention_plain_backward(q, k, v, g, **kw)
            rec["bwd_errs"], rec["bwd_tols"] = [], []
            for key, x, r, p in zip(("dq", "dk", "dv"), got, ref, plain):
                err = float((x.double() - r).abs().max())
                tol = max(_ulps(float(r.abs().max()), 4),
                          4 * float((p.double() - r).abs().max()))
                rec["bwd_errs"].append(err), rec["bwd_tols"].append(tol)
                if not err <= tol:
                    fails.append(f"flash edge {name} {key}: {err} > {tol}")
        recs.append(rec)
        log(f"flash edge case ({'backward' if backward else 'forward'}): "
            f"{json.dumps(rec)}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


# Shapes no captured site has, which the Hopper GEGLU kernel's tiling (128-
# or 64-token CTAs, 64-column output tiles per consumer, the output columns
# split at C > 320) makes risky, and widths that take the CUDA-core body:
# name: (tokens, C, the variant `geglu_variant` must pick)
GEGLU_EDGES = {
    "ragged_tokens_c320": (8 * 4096 - 37, 320, "wgmma_rows"),
    "ragged_tokens_c640": (8 * 1024 - 37, 640, "wgmma_cols"),
    "rows_c192": (1000, 192, "wgmma_rows"),
    "cols_c512": (1000, 512, "wgmma_cols"),
    "cuda_core_c448": (500, 448, "cuda_core"),
    "cuda_core_c32": (300, 32, "cuda_core"),
}
# The same for the tiled MMFS kernel (CTAs of one image row, head and query
# tile over every CFG half): name: (Lq, keywords of
# `bench_unet_kernels.mi_inputs`, the variant `mi_variant` must pick).
# "masked" zeroes image 1 of row 0 for heads 0-7 only; Lq = 1000 is neither
# square nor a whole number of tiles.
MI_EDGES = {
    "three_images_partial_mask": (1024, dict(n_img=3, Bv=2, B=4, live=(0, 1),
                                             masked=True), "tiled"),
    "no_cfg_sharing": (1024, dict(Bv=4, B=4), "tiled"),
    "uniform_out_of_range": (1024, dict(uniform=True), "tiled"),
    "ragged_queries": (1000, {}, "tiled"),
    "d32": (1024, dict(D=32), "tiled"),
    "d20": (256, dict(D=20), "flat"),
}


def _edge_check(tag, got, again, want, rec, fails) -> None:
    """One bf16 ulp at the output's scale, and two runs bit-identical."""
    import torch

    rec["err"] = float((got.float() - want.float()).abs().max())
    rec["tol"] = _ulps(float(want.float().abs().max()))
    rec["bit_identical"] = torch.equal(got, again)
    if not rec["err"] <= rec["tol"]:
        fails.append(f"{tag}: {rec['err']} > {rec['tol']}")
    if not rec["bit_identical"]:
        fails.append(f"{tag}: two runs differ")


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def _refuses_misaligned(tag, kernel, args, i, rec, fails) -> None:
    """The call with argument ``i`` misaligned raises before any launch."""
    args = list(args)
    args[i] = _misaligned(args[i])
    before = kernel.launches
    try:
        kernel(*args)
        rec["misaligned_refused"] = False
    except ValueError:
        rec["misaligned_refused"] = kernel.launches == before
    if not rec["misaligned_refused"]:
        fails.append(f"{tag}: a misaligned view was not refused before "
                     "launch")


def check_geglu_edges() -> list:
    """Each `GEGLU_EDGES` case in bf16, at the UNet block's scales (seeded),
    through the wrapper's own choice of variant: that choice as listed, the
    output within one bf16 ulp of the plain version, two runs
    bit-identical, and on the Hopper variants a misaligned x refused before
    any launch.  Every failure is gathered; the phase fails after the last
    case."""
    import torch

    from mm_interleaved_tpu_torch import bench_unet_kernels as bench
    from mm_interleaved_tpu_torch.ops import geglu as gmod

    recs, fails = [], []
    for i, (name, (T, C, want_variant)) in enumerate(GEGLU_EDGES.items()):
        args = bench.geglu_inputs(T, C, np.random.RandomState(SEED + 200 + i),
                                  "cuda")
        rec = dict(case=name, tokens=T, C=C,
                   variant=gmod.geglu_variant(C, 4 * C, torch.bfloat16))
        if rec["variant"] != want_variant:
            fails.append(f"geglu edge {name}: variant {rec['variant']} != "
                         f"{want_variant}")
        with torch.inference_mode():
            got = gmod.geglu_cuda(*args)
            again = gmod.geglu_cuda(*args)
            want = gmod.geglu_plain(*args)
        torch.cuda.synchronize()
        _edge_check(f"geglu edge {name}", got, again, want, rec, fails)
        if rec["variant"] != "cuda_core":
            with torch.inference_mode():
                _refuses_misaligned(f"geglu edge {name}", gmod.geglu_cuda,
                                    args, 0, rec, fails)
        recs.append(rec)
        log(f"geglu edge case: {json.dumps(rec)}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def check_mi_edges() -> list:
    """Each `MI_EDGES` case in bf16 (value [Bv, n_img, 5440, 16, D] over
    the UNet's four levels unless listed): the wrapper's choice of variant
    as listed, the output within one bf16 ulp of the plain version, two
    runs bit-identical, on the tiled variant a misaligned value refused
    before any launch, and, where an image is masked for some heads only,
    those heads' output unchanged when the masked image's values change
    (the skip is exact).  Every failure is gathered; the phase fails after
    the last case."""
    import torch

    from mm_interleaved_tpu_torch import bench_unet_kernels as bench
    from mm_interleaved_tpu_torch.ops import ms_deform_attn_mi as mmod

    recs, fails = [], []
    for i, (name, (Lq, make, want_variant)) in enumerate(MI_EDGES.items()):
        args = bench.mi_inputs(Lq, np.random.RandomState(SEED + 300 + i),
                               "cuda", **make)
        D = args[0].shape[-1]
        rec = dict(case=name, value=list(args[0].shape), lq=Lq,
                   variant=mmod.mi_variant(D, torch.bfloat16))
        if rec["variant"] != want_variant:
            fails.append(f"mi edge {name}: variant {rec['variant']} != "
                         f"{want_variant}")
        with torch.inference_mode():
            got = mmod.ms_deform_attn_mi_cuda(*args)
            again = mmod.ms_deform_attn_mi_cuda(*args)
            want = mmod.ms_deform_attn_mi_plain(*args)
            torch.cuda.synchronize()
            _edge_check(f"mi edge {name}", got, again, want, rec, fails)
            if rec["variant"] == "tiled":
                _refuses_misaligned(f"mi edge {name}",
                                    mmod.ms_deform_attn_mi_cuda, args, 0, rec,
                                    fails)
            if make.get("masked"):
                value = args[0].clone()
                value[0, 1] = 1e4  # image 1 of row 0, masked for heads 0-7
                moved = mmod.ms_deform_attn_mi_cuda(value, *args[1:])
                rows = torch.arange(args[4].shape[0], device="cuda") % \
                    args[0].shape[0] == 0
                heads = got.unflatten(-1, (-1, D))[rows][:, :, :8]
                rec["masked_skip_exact"] = bool(torch.equal(
                    heads, moved.unflatten(-1, (-1, D))[rows][:, :, :8]))
                if not rec["masked_skip_exact"]:
                    fails.append(f"mi edge {name}: a masked image moved the "
                                 "output")
        recs.append(rec)
        log(f"mi edge case: {json.dumps(rec)}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def compare_group_norm(sites_cases, want) -> dict:
    """GroupNorm(+SiLU) at each captured call shape ``want`` of the image
    path and at ``tiny``, in bf16 and fp32, through `group_norm_cuda` (the
    two kernels): two launches a call, the output within one bf16 ulp at
    its scale (fp32: 1e-5 of it) of the plain version, and two runs
    bit-identical; then each kernel on its own: the moments kernel's
    ``wb`` within 1e-5 of the plain moments' scale (fp32 sums of the same
    values in another order), the apply kernel on the plain ``wb`` within
    the whole op's tolerance.  Each kernel and the whole op timed beside
    the plain version's (CUDA events), the whole op also as device time by
    kernel and back to back, and without the SiLU beside `F.group_norm`
    on the same input (one PyTorch call computing GroupNorm).  Every failure is gathered; the phase fails
    after the last site.  Returns each kernel's site records."""
    import torch
    import torch.nn.functional as F

    from mm_interleaved_tpu_torch.ops import group_norm as gm

    moments, apply = (kernel_of(n) for n in GN)
    out, fails = {n: [] for n in GN}, []
    for site in want:
        (x, scale, bias, G, eps, silu), _ = sites_cases[site]
        base = dict(site=site, shapes=[list(x.shape)], groups=G, silu=silu)
        recs = {n: dict(base) for n in GN}
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            xa = x.to(dt)
            N = xa.numel() // (xa.shape[0] * xa.shape[-1])
            plan = gm.gn_plan(xa.shape[0], N, xa.shape[-1], dt)

            def whole(xa=xa):
                return gm.group_norm_cuda(xa, scale, bias, G, eps, silu)

            def plain_whole(xa=xa):
                return gm.group_norm_plain(xa, scale, bias, G, eps, silu)

            with torch.inference_mode():
                before = moments.launches + apply.launches
                y = whole()
                launched = moments.launches + apply.launches - before
                again = whole()
                want_y = plain_whole()
                wb = moments(xa, scale, bias, G, eps)
                wb_plain = gm.group_norm_moments_plain(xa, scale, bias, G,
                                                       eps)
                ya = apply(xa, wb_plain, silu)
                ya_plain = gm.group_norm_apply_plain(xa, wb_plain, silu)
                torch.cuda.synchronize()
            scale_y = float(want_y.float().abs().max())
            tol = (_ulps(scale_y) if tag == "bf16"
                   else 1e-5 * max(scale_y, 1.0))
            errs = dict(
                whole=float((y.float() - want_y.float()).abs().max()),
                moments=float((wb - wb_plain).abs().max()),
                apply=float((ya.float() - ya_plain.float()).abs().max()))
            tols = dict(whole=tol, apply=tol, moments=1e-5 * max(
                float(wb_plain.abs().max()), 1.0))
            for key in errs:
                if not errs[key] <= tols[key]:
                    fails.append(f"group_norm {site} {tag} {key}: "
                                 f"{errs[key]} > {tols[key]}")
            same = bool(torch.equal(y, again))
            if not same:
                fails.append(f"group_norm {site} {tag}: two runs differ")
            if launched != 2:
                fails.append(f"group_norm {site} {tag}: {launched} launches "
                             "a call")
            m, a = recs["group_norm_moments"], recs["group_norm_apply"]
            m.update({f"plan_{tag}": list(plan), f"launches_a_call_{tag}":
                      launched, f"bit_identical_{tag}": same,
                      f"whole_op_err_{tag}": errs["whole"],
                      f"whole_op_tol_{tag}": tol,
                      f"max_abs_err_{tag}": errs["moments"],
                      f"tol_{tag}": tols["moments"]})
            a.update({f"max_abs_err_{tag}": errs["apply"],
                      f"tol_{tag}": tol})
            with torch.inference_mode():
                m[f"ms_{tag}"] = time_ms(lambda: moments(xa, scale, bias, G,
                                                         eps))
                m[f"plain_ms_{tag}"] = time_ms(
                    lambda: gm.group_norm_moments_plain(xa, scale, bias, G,
                                                        eps))
                a[f"ms_{tag}"] = time_ms(lambda: apply(xa, wb_plain, silu))
                a[f"plain_ms_{tag}"] = time_ms(
                    lambda: gm.group_norm_apply_plain(xa, wb_plain, silu))
                m[f"whole_op_ms_{tag}"] = time_ms(whole)
                m[f"whole_op_plain_ms_{tag}"] = time_ms(plain_whole)
                if tag == "bf16":
                    n_el = xa.numel()
                    for r, (flops, nbytes) in (
                            (m, (3 * n_el, _nbytes(xa, scale, bias, wb))),
                            (a, (6 * n_el, _nbytes(xa, wb, y)))):
                        r["ops_ms"], r["bytes_ms"] = _bound(
                            flops, nbytes, PEAK_FP32_FLOPS)
                        r["bound_ms"] = max(r["ops_ms"], r["bytes_ms"])
                        r["bound_by"] = ("operations" if r["ops_ms"]
                                         > r["bytes_ms"] else "bytes")
                        r["library_ms"] = None
                    m["whole_op_bound_ms"] = max(_bound(
                        6 * n_el, _nbytes(xa, scale, bias, y),
                        PEAK_FP32_FLOPS))
                    by_kernel = device_ms_by_kernel(whole)
                    for r, key in ((m, "gn_moments"), (a, "gn_apply")):
                        r["device_ms"] = (None if by_kernel is None else sum(
                            ms for k, ms in by_kernel.items() if key in k))
                    m["queued_ms"] = queued_ms(lambda: moments(
                        xa, scale, bias, G, eps))
                    a["queued_ms"] = queued_ms(lambda: apply(xa, wb_plain,
                                                             silu))
                    m["whole_op_device_ms"] = (None if by_kernel is None
                                               else sum(by_kernel.values()))
                    m["whole_op_queued_ms"] = queued_ms(whole)
                    # GroupNorm without the SiLU is one PyTorch call (the
                    # yardstick; the port never calls it)
                    m["whole_op_library_ms"] = None if silu else time_ms(
                        lambda: F.group_norm(xa.permute(0, 3, 1, 2), G,
                                             scale, bias, eps))
            del y, again, want_y, wb, wb_plain, ya, ya_plain, xa
        for n in GN:
            out[n].append(recs[n])
            log(f"kernel vs plain, {n} {site}: {json.dumps(recs[n])}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return out


def whole_op_sums(sites) -> dict:
    """The whole GroupNorm op's times summed over the captured flagship
    sites (bf16), beside its bound, from the moments kernel's records."""
    main = [s for s in sites if s["site"] != TINY]
    dev = [s["whole_op_device_ms"] for s in main]
    return dict(
        ms=sum(s["whole_op_ms_bf16"] for s in main),
        plain_ms=sum(s["whole_op_plain_ms_bf16"] for s in main),
        bound_ms=sum(s["whole_op_bound_ms"] for s in main),
        device_ms=None if None in dev else sum(dev),
        queued_ms=sum(s["whole_op_queued_ms"] for s in main),
        launches_a_call=max(s["launches_a_call_bf16"] for s in sites))


def gn_f64(x, scale, bias, G, eps, silu):
    """The plain version's formula, E[x^2] - E[x]^2 included, in fp64."""
    import torch

    B, C = x.shape[0], x.shape[-1]
    xd = x.double().reshape(B, -1, C)
    cpg = C // G
    n = xd.shape[1] * cpg
    mean = xd.sum(1).reshape(B, G, cpg).sum(-1) / n
    var = (xd * xd).sum(1).reshape(B, G, cpg).sum(-1) / n - mean * mean
    w = scale.double() * torch.rsqrt(var + eps).repeat_interleave(cpg, -1)
    b = bias.double() - mean.repeat_interleave(cpg, -1) * w
    t = xd * w[:, None] + b[:, None]
    y = t * torch.sigmoid(t) if silu else t
    return y.reshape(x.shape), t, w, mean, var, n


# Shapes no captured site has, which the two GroupNorm kernels' layout (a
# thread a 16-byte column vector, a CTA R row groups, the chunks of a
# batch folded by its last CTA) makes risky: name: (B, px, C, groups,
# dtype, mean, the vector width `gn_plan` must pick).  "large_mean" is
# fp32 with mean 8 and std 1, where E[x^2] - E[x]^2 cancels; it is held
# against the same formula in fp64 (`check_gn_edges` states its tolerance)
GN_EDGES = {
    "scalar_c20": (2, 16, 20, 4, "bfloat16", 0.0, 1),
    "straddle_c320_g32": (2, 24, 320, 32, "bfloat16", 0.0, 8),
    "one_group": (2, 16, 64, 1, "bfloat16", 0.0, 8),
    "one_row": (3, 1, 320, 32, "bfloat16", 0.0, 8),
    "b1": (1, 32, 128, 32, "bfloat16", 0.0, 8),
    "large_mean": (2, 32, 320, 32, "float32", 8.0, 4),
    # 504 threads (21 vectors x 24 row groups): 15 whole warps and one of
    # 24 lanes, fewer whole warps than groups
    "c192_g16": (2, 16, 192, 16, "bfloat16", 0.0, 8),
    "c192_g32": (2, 16, 192, 32, "bfloat16", 0.0, 8),
}


def check_gn_edges() -> list:
    """Each `GN_EDGES` case with and without the SiLU, scale and bias in
    bf16 as the model keeps them: the vector width as listed, two runs
    bit-identical, and the output within one bf16 ulp at its scale of the
    plain version (fp32: 1e-5).  "large_mean": the kernels and the plain
    version each against `gn_f64`, within a tolerance derived from the fp32
    rounding of s2: with u = 2^-24 and n = N * C / G terms a group, the
    sums carry about 4 sqrt(n) u of relative error (random rounding, four
    standard deviations), so var is off by dv = 4 sqrt(n) u E[x^2] and the
    mean by dm = 4 sqrt(n) u |mean|, and y by at most 1.1 (max|t| dv /
    (2 (var + eps)) + max|w| dm), 1.1 the steepest slope of the SiLU.  A
    view of x off a 16-byte boundary at the vector widths is refused by
    both kernels before any launch.  Every failure is gathered; the phase
    fails after the last case."""
    import torch

    from mm_interleaved_tpu_torch.ops import group_norm as gm

    recs, fails = [], []
    for i, (name, (B_, px, C, G, dt, mean, width)) in enumerate(
            GN_EDGES.items()):
        rng = np.random.RandomState(SEED + 400 + i)
        dt = getattr(torch, dt)
        x = torch.tensor(rng.randn(B_, px, px, C) + mean, dtype=dt,
                         device="cuda")
        scale, bias = (torch.tensor(a, dtype=torch.bfloat16, device="cuda")
                       for a in (1 + 0.1 * rng.randn(C), 0.1 * rng.randn(C)))
        plan = gm.gn_plan(B_, px * px, C, dt)
        rec = dict(case=name, x=list(x.shape), groups=G, dtype=str(dt),
                   plan=list(plan))
        if plan[0] != width:
            fails.append(f"gn edge {name}: width {plan[0]} != {width}")
        for silu in (True, False):
            tag = f"gn edge {name} silu={silu}"
            with torch.inference_mode():
                got = gm.group_norm_cuda(x, scale, bias, G, 1e-6, silu)
                again = gm.group_norm_cuda(x, scale, bias, G, 1e-6, silu)
                want = gm.group_norm_plain(x, scale, bias, G, 1e-6, silu)
                torch.cuda.synchronize()
            r = rec.setdefault("silu" if silu else "norm", {})
            if mean:
                ref, t, w, mu, var, n = gn_f64(x, scale, bias, G, 1e-6, silu)
                u = 2.0 ** -24
                e2 = float((var + mu * mu).max())
                dv = 4 * n ** 0.5 * u * e2
                dm = 4 * n ** 0.5 * u * float(mu.abs().max())
                tol = 1.1 * (float(t.abs().max()) * dv
                             / (2 * (float(var.min()) + 1e-6))
                             + float(w.abs().max()) * dm)
                r.update(tol=tol, bit_identical=bool(torch.equal(got,
                                                                 again)))
                for who, y in (("kernels", got), ("plain", want)):
                    r[f"err_{who}"] = float((y.double() - ref).abs().max())
                    if not r[f"err_{who}"] <= tol:
                        fails.append(f"{tag} {who} vs fp64: "
                                     f"{r[f'err_{who}']} > {tol}")
                if not r["bit_identical"]:
                    fails.append(f"{tag}: two runs differ")
            else:
                _edge_check(tag, got, again, want, r, fails)
        if width > 1:
            with torch.inference_mode():
                wb = gm.group_norm_moments_plain(x, scale, bias, G, 1e-6)
                for kname, args in (("group_norm_moments",
                                     (x, scale, bias, G, 1e-6)),
                                    ("group_norm_apply", (x, wb, True))):
                    r = rec.setdefault(kname, {})
                    _refuses_misaligned(f"gn edge {name} {kname}",
                                        kernel_of(kname), args, 0, r, fails)
        recs.append(rec)
        log(f"group norm edge case: {json.dumps(rec)}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


# Shapes no site has, which the deformable kernels' Hopper bodies make
# risky, and widths and sizes that take their other bodies: name:
# (keywords of `deform_bwd_edge_case`, the bodies the pure functions must
# pick: kernel 1's `forward_variant`, kernel 2's `value_grad_plan` table and
# body, kernel 3's `loc_weight_variant`).  Q = 300 fills no whole number of
# CTAs; "lp_9" has L * P = 9 samples a query-head, not a multiple of the 4 a
# warp holds at D = 64; "all_corners_out" puts every corner out of bounds
# (every gradient exactly 0); "one_cell" every sample of an (n, h) in one
# cell (the four texels around it walk 16,384 samples each); a 128 x 128
# level keeps the value gradient's cell table in device memory; the default
# two levels walk by group (level 0) and by warp (level 1).
_HOPPER = dict(fwd="grouped", table="shared", value="grouped",
               loc_weight="grouped")
_ANY_D = dict(fwd="channel", table="shared", value="lanes", loc_weight="warp")
DEFORM_BWD_EDGES = {
    "d16": (dict(D=16), _ANY_D),
    "d32": (dict(D=32), _HOPPER),
    "d128": (dict(D=128), _HOPPER),
    "all_corners_out": (dict(out=True), _HOPPER),
    "lp_9": (dict(shapes=((16, 16), (8, 8), (4, 4)), P=3), _HOPPER),
    "fp32": (dict(dtype="float32"), _HOPPER),
    "fp32_locations": (dict(loc_dtype="float32"), _HOPPER),
    "warp_d20": (dict(D=20), _ANY_D),
    "one_cell": (dict(shapes=((16, 16),), one_cell=True, Q=2048, P=8),
                 _HOPPER),
    "global_table": (dict(shapes=((128, 128),), N=1, H=2),
                     dict(_HOPPER, table="global")),
    "global_table_d20_fp32": (dict(shapes=((128, 128),), N=1, H=2, D=20,
                                   dtype="float32"),
                              dict(_ANY_D, table="global")),
}


def deform_bwd_edge_case(rng, D=64, dtype="bfloat16", shapes=((16, 16),
                                                              (8, 8)),
                         P=4, out=False, N=2, Q=300, H=4, one_cell=False,
                         loc_dtype=None):
    """``(value, shapes, loc, w, grad_out)`` on the card: locations uniform
    over [-0.1, 1.1] (some corners out of bounds), over [1.6, 3] with
    ``out`` (every corner), or all at (0.37, 0.37) with ``one_cell``;
    locations and weights in ``loc_dtype`` (default: the values')."""
    import torch

    dt = getattr(torch, dtype)
    lt = getattr(torch, loc_dtype or dtype)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    lo, hi = (1.6, 3.0) if out else (-0.1, 1.1)
    loc = rng.uniform(lo, hi, (N, Q, H, L, P, 2))
    if one_cell:
        loc[:] = 0.37

    def dev(a, t=dt):
        return torch.tensor(a, dtype=t, device="cuda")

    return (dev(rng.randn(N, S, H, D)), shapes, dev(loc, lt),
            dev(rng.rand(N, Q, H, L, P), lt), dev(rng.randn(N, Q, H * D)))


def check_deform_bwd_edges() -> list:
    """Kernels 1, 2 and 3 at each `DEFORM_BWD_EDGES` case: the bodies and
    plan as listed; against the plain version in fp32 (its autograd for the
    gradients) with the sites' tolerances (the output one bf16 ulp at its
    scale, the gradients 2; fp32 1e-5 of the scale); exact zeros where every
    corner is out of bounds; two runs bit-identical; and where a body loads
    16-byte vectors, a view off a 16-byte boundary refused before any launch
    (kernel 1's value, kernel 2's dOut, kernel 3's value).  Every failure is
    gathered; the phase fails after the last case."""
    import torch

    from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk

    k1 = kernel_of("ms_deform_attn_fwd")
    k2 = kernel_of("ms_deform_attn_bwd_value")
    k3 = kernel_of("ms_deform_attn_bwd_loc_weight")
    recs, fails = [], []
    for i, (name, (kw, want)) in enumerate(DEFORM_BWD_EDGES.items()):
        tag = f"deform edge {name}"
        args = deform_bwd_edge_case(np.random.RandomState(SEED + 500 + i),
                                    **kw)
        value, shapes, loc, w, go = args
        N, Q, H, L, P, _ = loc.shape
        D = value.shape[-1]
        plan = dk.value_grad_plan(shapes, Q, L, P, D, value.dtype)
        rec = dict(case=name, value=list(value.shape), loc=list(loc.shape),
                   loc_dtype=str(loc.dtype), plan=plan._asdict(),
                   bodies=dict(fwd=dk.forward_variant(D, value.dtype),
                               table=plan.table, value=plan.body,
                               loc_weight=dk.loc_weight_variant(
                                   D, value.dtype)))
        if rec["bodies"] != want:
            fails.append(f"{tag}: bodies {rec['bodies']} != {want}")
        got = dict(fwd=(k1(*args[:4]), k1(*args[:4])),
                   value=(k2(*args), k2(*args)),
                   loc_weight=(k3(*args), k3(*args)))
        f32 = [x.float() if isinstance(x, torch.Tensor) else x for x in args]
        ref = dict(fwd=dk.ms_deform_attn_plain(*f32[:4]))
        ref["value"], d_loc, d_w = dk.ms_deform_attn_plain_backward(*f32)
        ref["loc_weight"] = (d_loc, d_w)
        torch.cuda.synchronize()
        rec["errs"], rec["tols"], rec["bit_identical"] = {}, {}, {}
        for k in ("fwd", "value", "loc_weight"):
            first, again = got[k]
            first = first if isinstance(first, tuple) else (first,)
            again = again if isinstance(again, tuple) else (again,)
            want_k = ref[k] if isinstance(ref[k], tuple) else (ref[k],)
            rec["bit_identical"][k] = all(bool(torch.equal(a, b))
                                          for a, b in zip(first, again))
            if not rec["bit_identical"][k]:
                fails.append(f"{tag} {k}: two runs differ")
            errs, tols = [], []
            for g, r in zip(first, want_k):
                scale = float(r.abs().max())
                if value.dtype == torch.float32:
                    tol = 1e-5 * (max(scale, 1.0) if k == "fwd" else scale)
                else:
                    tol = _ulps(scale, 1 if k == "fwd" else 2)
                err = float((g.double() - r.double()).abs().max())
                errs.append(err), tols.append(tol)
                if not err <= tol:
                    fails.append(f"{tag} {k}: {err} > {tol}")
                if kw.get("out") and bool((g != 0).any()):
                    fails.append(f"{tag} {k}: nonzero with every corner "
                                 "out of bounds")
            rec["errs"][k], rec["tols"][k] = errs, tols
        for k, kernel, arg in (("fwd", k1, 0), ("value", k2, 4),
                               ("loc_weight", k3, 0)):
            if rec["bodies"][k] == "grouped":
                sub = {}
                _refuses_misaligned(f"{tag} {k}", kernel,
                                    args[:4] if k == "fwd" else args, arg,
                                    sub, fails)
                rec[f"misaligned_refused_{k}"] = sub["misaligned_refused"]
        recs.append(rec)
        log(f"deform edge case: {json.dumps(rec)}")
        del got, ref
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def check_forward_at_training_sites(sites_cases) -> list:
    """Kernel 1 at each `_DEFORM_TRAIN` site (value, locations and weights
    from the captured backward inputs), in bf16 and fp32: against its plain
    version in the same dtype (one bf16 ulp at the output's scale; fp32
    1e-5 of it), bit-identical over two runs, timed beside its bound (bf16;
    events, and device time and back to back at the UNet's 64 and 32 px).
    The failures are gathered; the phase fails after the last site."""
    import torch

    mod = kmod("ms_deform_attn_fwd")
    kernel, plain = kernel_of("ms_deform_attn_fwd"), mod.ms_deform_attn_plain
    recs, fails = [], []
    for site in _DEFORM_TRAIN:
        args, _ = sites_cases[site]
        rec = dict(site=site, shapes=[list(a.shape) for a in args[:4]
                                      if isinstance(a, torch.Tensor)])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = tuple(x.to(dt) if isinstance(x, torch.Tensor) else x
                      for x in args[:4])
            with torch.inference_mode():
                got, again, want = kernel(*a), kernel(*a), plain(*a)
                torch.cuda.synchronize()
                scale = float(want.float().abs().max())
                tol = 1e-5 * max(scale, 1.0) if tag == "fp32" else _ulps(scale)
                err = float((got.float() - want.float()).abs().max())
                rec[f"max_abs_err_{tag}"], rec[f"tol_{tag}"] = err, tol
                rec[f"bit_identical_{tag}"] = bool(torch.equal(got, again))
                if not err <= tol:
                    fails.append(f"kernel 1 {site} {tag}: {err} > {tol}")
                if not rec[f"bit_identical_{tag}"]:
                    fails.append(f"kernel 1 {site} {tag}: two runs differ")
                if tag == "bf16":
                    rec["ms_bf16"] = time_ms(lambda: kernel(*a))
                    flops, nbytes, rate = WORK["ms_deform_attn_fwd"](a, {},
                                                                     got)
                    rec["bound_ms"] = max(_bound(flops, nbytes, rate))
                    if site in ("unet_64px", "unet_32px"):
                        rec["device_ms"] = device_ms(lambda: kernel(*a))
                        rec["queued_ms"] = queued_ms(lambda: kernel(*a))
            del got, again, want
        recs.append(rec)
        log(f"kernel 1 at a training site: {json.dumps(rec)}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def sites_dir():
    """Where the captured flagship inputs go for `bench_unet_kernels
    --sites` (under the git-ignored build directory): a file a kernel."""
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    return BUILD_DIR.parent / "sites"


def save_sites(cases, names) -> str:
    """Write the captured flagship inputs of each of ``names`` to ``<sites
    dir>/<name>.pt``, on the host; returns the directory.  `main` empties
    the directory first, so a file there is this run's."""
    import torch

    path = sites_dir()
    path.mkdir(parents=True, exist_ok=True)
    for name in names:
        torch.save({site: tuple(a.cpu() if isinstance(a, torch.Tensor)
                                else a for a in args)
                    for site, (args, _) in cases[name].items()
                    if site != TINY}, path / f"{name}.pt")
    return str(path)


def compare_backward(name, sites_cases, sites=None) -> list:
    """Each backward kernel at each captured site (of ``sites``, by default
    every site the path must have), its inputs rounded to
    bf16 or kept fp32, against autograd through a reference on the same
    inputs: the plain version in fp32 for the deformable kernels, attention
    in fp64 for flash attention (with `check_training_forward` on its
    forward and `delta_reading` on its dQ).  Tolerance:
    the larger of the base and, for flash attention, 4x the error the
    plain version makes itself in the same dtype against the fp64
    reference (dQ is a small difference of large terms where the keys
    share a common component, as the ViT's and the Q-Former's do).  Base,
    fp32: 1e-5 x each gradient's scale (the same sums in another order);
    bf16: a few ulps at the scale, 2 for the deformable kernels, which
    round only their outputs, 4 for flash attention, which also rounds P
    and dS to bf16 for dV and dK.  Each site's failures are gathered and
    the phase fails after the last site.  Timed beside the plain version's
    backward in the same dtype."""
    import torch

    from mm_interleaved_tpu_torch.ops import flash_attention as fa

    kernel = kernel_of(name)
    flash = name == "flash_attention_bwd"
    ulps = 4 if flash else 2
    recs, fails = [], []
    for site in sites or WANT_SITES[name]:
        args, kw = sites_cases[site]
        kw = {k: v for k, v in kw.items() if k != "return_lse"}
        rec = dict(site=site, shapes=[list(x.shape) for x in args
                                      if isinstance(x, torch.Tensor)])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a, n_in, wrt, fn, fwd = _backward_case(name, args, kw, dt)
            if flash:
                rec[f"forward_{tag}"] = check_training_forward(a, kw, fwd, tag,
                                                              fails)
            got = kernel(*a, **kw)
            got = got if isinstance(got, tuple) else (got,)
            if tag == "bf16" and (not flash or site == "unet_attn1_64px"):
                # no float atomics: the same gradients bit for bit
                again = kernel(*a, **kw)
                again = again if isinstance(again, tuple) else (again,)
                rec["bit_identical"] = all(torch.equal(x, y)
                                           for x, y in zip(got, again))
                if not rec["bit_identical"]:
                    fails.append(f"{name} {site}: two runs differ")
                del again
            grad_out = a[3] if flash else a[4]
            ref_dt = torch.float64 if flash else torch.float32
            ref_fn = ((lambda *x: attention_f64(*x, **kw)) if flash else fn)
            with torch.enable_grad():
                ins = [x.detach().to(ref_dt).requires_grad_(i in wrt)
                       if isinstance(x, torch.Tensor) else x
                       for i, x in enumerate(a[:n_in])]
                ref = torch.autograd.grad(ref_fn(*ins),
                                          [ins[i] for i in wrt],
                                          grad_out.to(ref_dt))
            plain = (fa.attention_plain_backward(*a[:3], grad_out, **kw)
                     if flash else None)
            torch.cuda.synchronize()
            errs, tols, scales, plain_errs = [], [], [], []
            for i, (g, r) in enumerate(zip(got, ref)):
                err = float((g.double() - r).abs().max())
                scale = float(r.abs().max())
                tol = 1e-5 * scale if tag == "fp32" else _ulps(scale, ulps)
                if plain is not None:
                    plain_errs.append(float(
                        (plain[i].double() - r).abs().max()))
                    tol = max(tol, 4 * plain_errs[-1])
                if not err <= tol:
                    fails.append(f"{name} {site} {tag}: kernel vs plain "
                                 f"{err} > {tol}")
                errs.append(err), tols.append(tol), scales.append(scale)
            if flash:
                rec[f"plain_errs_{tag}"] = plain_errs
                rec[f"delta_reading_{tag}"] = delta_reading(
                    a, kw, fwd["out"], ref[0])
            rec[f"max_abs_err_{tag}"] = max(errs)
            rec[f"errs_{tag}"] = errs
            rec[f"tol_{tag}"] = tols
            rec[f"scale_{tag}"] = scales
            rec[f"ms_{tag}"] = time_ms(lambda: kernel(*a, **kw))
            rec[f"plain_ms_{tag}"] = time_ms(_grad_timer(fn, a[:n_in], wrt,
                                                         grad_out))
            if tag == "bf16":
                flops, nbytes, rate = WORK[name](a, kw, got)
                rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes, rate)
                rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                rec["bound_by"] = ("operations" if rec["ops_ms"]
                                   > rec["bytes_ms"] else "bytes")
                rec["flops"], rec["bytes"] = flops, nbytes
                rec["library_ms"] = (time_ms(sdpa_grad_timer(a, kw))
                                     if name == "flash_attention_bwd"
                                     else None)
                if flash or site != TINY:
                    rec["device_ms"] = device_ms(lambda: kernel(*a, **kw))
                    rec["queued_ms"] = queued_ms(lambda: kernel(*a, **kw))
                if flash:
                    lib = sdpa_grad_timer(a, kw)
                    rec["library_device_ms"] = device_ms(lib)
                    rec["library_queued_ms"] = queued_ms(lib)
            del got, ref, plain, a, fwd
        recs.append(rec)
        log(f"kernel vs plain, {name} {site}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def device_sums(sites) -> dict:
    """The kernel's (and, for flash attention, the library's) device times
    summed over the sites where the profiler read every one of them, with
    those sites' count, and their back-to-back times over every site; empty
    for the kernels of no `DEVICE_TIMED` site."""
    if not any("device_ms" in s for s in sites):
        return {}
    lib = any("library_device_ms" in s for s in sites)
    keys = ("device_ms", "library_device_ms") if lib else ("device_ms",)
    read = [s for s in sites if all(s.get(k) is not None for k in keys)]
    out = {k: sum(s[k] for s in read) for k in keys}
    out["device_sites"] = len(read)
    for k in ("queued_ms", "library_queued_ms") if lib else ("queued_ms",):
        out[k] = sum(s[k] for s in sites)
    return out


def kernel_line(name, sites, launches,
                timing="sum over the captured flagship call sites") -> dict:
    """The kernel's entry of the ``{"kernels": [...]}`` line: times summed
    over its captured flagship call sites (bf16), errors over every site."""
    main = [s for s in sites if s["site"] != TINY]
    ops_ms = sum(s["ops_ms"] for s in main)
    bytes_ms = sum(s["bytes_ms"] for s in main)
    lib = [s["library_ms"] for s in main]
    info = KERNELS[name]
    return {
        "name": name,
        "route": "cuda",
        "source": f"mm_interleaved_tpu_torch/csrc/{info['source']}",
        "replaces": info["replaces"],
        "launches": launches,
        "max_abs_err": max(s["max_abs_err_bf16"] for s in sites),
        "max_abs_err_fp32": max(s["max_abs_err_fp32"] for s in sites),
        "ms": sum(s["ms_bf16"] for s in main),
        "plain_ms": sum(s["plain_ms_bf16"] for s in main),
        "bound_ms": sum(s["bound_ms"] for s in main),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "library_ms": None if None in lib else sum(lib),
        "timing": f"{timing}, bf16, median of {TIMING_RUNS} CUDA-event "
                  "runs each",
        **device_sums(main),
        "sites": sites,
    }


def v4_corners(loc, w, shapes):
    """Per level ``(texel, term)``, each ``[N, Q, H, P, 4]``: each sample's
    four corner texels on its level (row-major corners, -1 outside the
    grid) and terms hat(x - xs) * (hat(y - ys) * aw), as the v4 gathers
    enumerate and form them; xs = loc * size - 0.5 in one rounding, as
    ``v4_coord``'s fused multiply-add (exact in fp64, then rounded)."""
    import torch

    out = []
    dx = torch.tensor([0, 1, 0, 1], device=loc.device)
    dy = torch.tensor([0, 0, 1, 1], device=loc.device)
    hat = lambda t: (1.0 - t.abs()).clamp_min(0.0)
    for lid, (h, w_) in enumerate(shapes):
        xs = (loc[:, :, :, lid, :, 0].double() * w_ - 0.5).float()
        ys = (loc[:, :, :, lid, :, 1].double() * h - 0.5).float()
        cx = torch.floor(xs)[..., None] + dx
        cy = torch.floor(ys)[..., None] + dy
        inside = (cx >= 0) & (cx < w_) & (cy >= 0) & (cy < h)
        wy = hat(cy - ys[..., None]) * w[:, :, :, lid, :, None].float()
        term = hat(cx - xs[..., None]) * wy
        out.append((torch.where(inside, cy * w_ + cx, -1).long(), term))
    return out


def v4_pairs(loc, w, shapes, dtype) -> tuple:
    """The (query, level, texel) pairs of the v4 gathers on these inputs:
    ``(corners in the grid, pairs, pairs whose merged A rounds to a
    non-zero in dtype)``."""
    import torch

    inside = pairs = nonzero = 0
    for texel, term in v4_corners(loc, w, shapes):
        k = texel.flatten(3)
        k, order = torch.sort(k, dim=-1, stable=True)
        t = torch.gather(term.flatten(3), -1, order)
        live = k >= 0
        start = live.clone()
        start[..., 1:] &= k[..., 1:] != k[..., :-1]
        seg = torch.cumsum(start.flatten().long(), 0) - 1
        sums = torch.zeros(int(start.sum()), device=k.device)
        sums.index_add_(0, seg[live.flatten()], t.flatten()[live.flatten()])
        inside += int(live.sum())
        pairs += sums.numel()
        nonzero += int((sums.to(dtype) != 0).sum())
        del k, order, t, live, start, seg, sums
    return inside, pairs, nonzero


def design_ops(name, args) -> dict:
    """The operations the kernel's own design performs (beside the bound,
    which counts the function's work and does not change with the
    formulation), counted on this run's inputs.  8a, a gather: per sample
    four corner terms (two hats and two products each), then per distinct
    texel of a (query, level)'s corners one row of D read and D FMAs; 8c,
    a gather: per in-grid corner one row of D read and D FMAs (its dot
    product), per sample a blend of the four; 8b, texel-major: four keys
    written a sample, every in-grid corner walked (its term formed again),
    the corners merged into (query, texel) pairs, one row of g read and D
    FMAs a pair whose A is not 0; 9, kernel 1's body: per in-grid corner
    one row of D read, 7 flops a sample and channel (4 for the two row
    blends, 3 for the column weights)."""
    value, shapes, loc, w = args[:4]
    N, Q, H, L, P, _ = loc.shape
    D = value.shape[3]
    samples = N * Q * H * L * P
    if name == "ms_deform_attn_v4_fwd":
        inside, rows, _ = v4_pairs(loc, w, shapes, value.dtype)
        return dict(corner_terms=4 * samples, texel_rows=rows,
                    fmas=rows * D)
    if name == "ms_deform_attn_v4_bwd_loc_weight":
        rows = sum(int((t >= 0).sum())
                   for t, _ in v4_corners(loc, w, shapes))
        return dict(corner_rows=rows, fmas=rows * D, blends=samples)
    if name == "ms_deform_attn_v4_bwd_value":
        inside, pairs, rows = v4_pairs(loc, w, shapes, value.dtype)
        return dict(keys_written=4 * samples, entries_walked=inside,
                    pairs=pairs, g_rows=rows, fmas=rows * D)
    rows = sum(int((t >= 0).sum()) for t in v1_corner_texels(loc, shapes))
    return dict(texel_rows=rows, flops=7 * samples * D)


def v1_corner_texels(loc, shapes):
    """Per level ``[N, Q, H, P, 4]``: each sample's four corner texels on
    its level by ``deform::corners`` (x = loc * size - 0.5, the product
    rounded, then the difference; -1 outside the grid)."""
    import torch

    out = []
    dx = torch.tensor([0, 1, 0, 1], device=loc.device)
    dy = torch.tensor([0, 0, 1, 1], device=loc.device)
    for lid, (h, w_) in enumerate(shapes):
        cx = torch.floor(loc[:, :, :, lid, :, 0].float() * w_ - 0.5)
        cy = torch.floor(loc[:, :, :, lid, :, 1].float() * h - 0.5)
        cx, cy = cx.long()[..., None] + dx, cy.long()[..., None] + dy
        inside = (cx >= 0) & (cx < w_) & (cy >= 0) & (cy < h)
        out.append(torch.where(inside, cy * w_ + cx, -1))
    return out


def compare_bench(name, res) -> list:
    """Phase 9's checks of one benchmark kernel at each of the benchmark's
    cases, on its inputs (bf16 values) and with the values in fp32: the
    kernel against its plain version (bf16 within 2 ulps at the output's
    scale: only the order of the sums differs; fp32 within 1e-5 of the
    scale) and against kernel 1, the same function in another formulation
    (bf16 within 2e-2 of kernel 1's scale, as tests/test_pallas_kernel.py
    allows v4 against the gather; fp32 1e-4).  The bf16 time is the
    benchmark's own; the fp32 time and the plain versions' (median of
    PLAIN_RUNS) are taken here; kernel 1's bf16 time on the same inputs,
    the benchmark's, is recorded beside the kernel's.  Every failure is
    gathered; the phase fails after the last case."""
    import torch

    mod = kmod(name)
    kernel = getattr(mod, KERNELS[name]["kernel"])
    plain = getattr(mod, KERNELS[name]["plain"])
    kernel1 = kernel_of("ms_deform_attn_fwd")
    form = BENCH[name]
    sites, fails = [], []
    for case, args in res["inputs"].items():
        row = next(r for r in res["rows"]
                   if r["case"] == case and r["formulation"] == form)
        k1_row = next(r for r in res["rows"]
                      if r["case"] == case and r["formulation"] == "kernel1")
        rec = dict(site=case, shapes=[list(x.shape) for x in args
                                      if isinstance(x, torch.Tensor)],
                   ms_bf16=row["ms"], kernel1_ms_bf16=k1_row["ms"])
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = (args[0].to(dt),) + tuple(args[1:])
            with torch.inference_mode():
                got = (res["outputs"][case][form] if tag == "bf16"
                       else kernel(*a))
                want = plain(*a)
                ref = kernel1(*a)
                torch.cuda.synchronize()
                got, want, ref = got.float(), want.float(), ref.float()
                scale = float(want.abs().max())
                scale1 = float(ref.abs().max())
                err = float((got - want).abs().max())
                err1 = float((got - ref).abs().max())
            if tag == "bf16":
                tol = _ulps(scale, 2)
                tol1 = 2e-2 * scale1
            else:
                tol, tol1 = 1e-5 * scale, 1e-4 * scale1
            if not err <= tol:
                fails.append(f"{name} {case} {tag}: kernel vs plain {err} > "
                             f"{tol}")
            if not err1 <= tol1:
                fails.append(f"{name} {case} {tag}: kernel vs kernel 1 "
                             f"{err1} > {tol1}")
            rec.update({f"max_abs_err_{tag}": err, f"tol_{tag}": tol,
                        f"scale_{tag}": scale,
                        f"err_vs_kernel1_{tag}": err1,
                        f"tol_vs_kernel1_{tag}": tol1})
            with torch.inference_mode():
                if tag == "fp32":
                    rec["ms_fp32"] = time_ms(lambda: kernel(*a))
                rec[f"plain_ms_{tag}"] = time_ms(lambda: plain(*a),
                                                 PLAIN_RUNS)
            if tag == "bf16":
                flops, nbytes, rate = work_deform(a, {}, got.to(dt))
                rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes, rate)
                rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                rec["bound_by"] = ("operations" if rec["ops_ms"]
                                   > rec["bytes_ms"] else "bytes")
                rec["flops"], rec["bytes"] = flops, nbytes
                rec["library_ms"] = None
                rec["design_ops"] = design_ops(name, a)
            del got, want, ref
        sites.append(rec)
        log(f"kernel vs plain and kernel 1, {name} {case}: {json.dumps(rec)}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return sites


# The v1 forward (kernel 9) at the edges of its two bodies: D = 16 (bf16:
# two 16-byte vectors, the "channel" body), 32, 64 and 128 (bf16: the 4-,
# 8- and 16-lane groups of kernel 1's grouped body), fp32 at D = 16 and 64
# (4 and 16 lanes), bf16 locations, corners outside the grid (locations
# over [-0.2, 1.2], the default), whole-texel coordinates (power-of-two
# levels), non-square levels with L * P over 32 (two rounds of a query's
# samples), the "channel" body at fp32 D = 20, and a value view off a
# 16-byte boundary, refused where the body is "grouped".
V1_EDGES = {
    "d16_channel": dict(D=16),
    "d32": dict(D=32),
    "d64_out_of_grid": dict(),
    "d128": dict(D=128),
    "fp32_d16": dict(dtype="float32", D=16),
    "fp32_d64": dict(dtype="float32"),
    "bf16_locations": dict(loc_dtype="bfloat16"),
    "kinks": dict(draw="whole"),
    "nonsquare_p12": dict(P=12, shapes=((12, 16), (6, 8), (3, 5)), Q=100),
    "channel_fp32_d20": dict(dtype="float32", D=20),
    "misaligned_value": dict(misaligned=True),
}


def check_v1_edges() -> list:
    """Kernel 9 at each `V1_EDGES` case against its plain version with the
    benchmark's tolerances (2 bf16 ulps at the output's scale, fp32 1e-5 of
    it), two calls bit-identical, its body (`forward_variant`) logged; with
    ``misaligned`` the call refused before any launch.  Every failure is
    gathered; the phase fails after the last case."""
    import torch

    from mm_interleaved_tpu_torch.ops import ms_deform_attn_cuda as dk

    name = "ms_deform_attn_v1_fwd"
    kernel, plain = kernel_of(name), getattr(kmod(name),
                                             KERNELS[name]["plain"])
    recs, fails = [], []
    for i, (case, kw) in enumerate(V1_EDGES.items()):
        tag = f"v1 edge {case}"
        args = v4_edge_case(np.random.RandomState(SEED + 900 + i),
                            **{k: v for k, v in kw.items()
                               if k != "misaligned"})[:4]
        value = args[0]
        D = value.shape[-1]
        rec = dict(case=case, value=list(value.shape),
                   loc=list(args[2].shape), loc_dtype=str(args[2].dtype),
                   body=dk.forward_variant(D, value.dtype))
        if kw.get("misaligned"):
            _refuses_misaligned(tag, kernel, args, 0, rec, fails)
            recs.append(rec)
            log(f"v1 edge case: {json.dumps(rec)}")
            continue
        with torch.inference_mode():
            first, again = kernel(*args), kernel(*args)
            want = plain(*args)
            torch.cuda.synchronize()
        rec["bit_identical"] = bool(torch.equal(first, again))
        if not rec["bit_identical"]:
            fails.append(f"{tag}: two calls differ")
        scale = float(want.float().abs().max())
        tol = (1e-5 * scale if value.dtype == torch.float32
               else _ulps(scale, 2))
        err = float((first.double() - want.double()).abs().max())
        rec.update(err=err, tol=tol, scale=scale)
        if not err <= tol:
            fails.append(f"{tag}: {err} > {tol}")
        recs.append(rec)
        log(f"v1 edge case: {json.dumps(rec)}")
        del first, again, want, args
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def run_bench_phase() -> list:
    """Phase 9: the benchmark entry point on the card with every count at
    0 just before it, its v1, v4 and kernel-1 launches equal to the calls
    it made, then `compare_bench` for v1 and v4 and `check_v1_edges`;
    returns their entries of the kernels line."""
    from mm_interleaved_tpu_torch import bench_deform_kernel as bench

    reset_counts()
    res = bench.run("cuda")
    got = read_counts()
    for row in res["rows"]:
        log(f"bench_deform_kernel: {json.dumps(row)}")
    want = {name: res["calls"][form] for name, form in BENCH.items()}
    want["ms_deform_attn_fwd"] = res["calls"]["kernel1"]
    for name, n in want.items():
        if n == 0 or got[name] != n:
            raise AssertionError(f"{name}: {got[name]} launches in the "
                                 f"benchmark, {n} calls made")
    log(f"benchmark launches {json.dumps(got)}")
    lines = [kernel_line(name, compare_bench(name, res), got[name],
                         timing="sum over the benchmark's unet and prefill "
                                "cases")
             for name in BENCH]
    t0 = time.perf_counter()
    check_v1_edges()
    log(f"check_v1_edges: {time.perf_counter() - t0:.1f} s")
    return lines


def compare_v4_backward(res) -> dict:
    """Phase 10's checks of kernels 8b and 8c at each case of the
    v4-against-v5 benchmark, on its inputs (bf16 values) and with the
    values in fp32, with the benchmark's dOut (twice v4's output, in the
    value's dtype).  Against their plain versions: dV within 2 bf16 ulps at
    its scale (the same roundings, the sums in another order), fp32 within
    1e-5 of the scale; d_loc and d_w within 1e-4 (bf16) and 1e-5 (fp32) of
    their scales (fp32 sums of the same terms).  Against kernels 2 and 3,
    the same function in another formulation: dV within 2e-2 of kernel 2's
    scale in bf16 (v4 rounds A) and 1e-4 in fp32; d_loc and d_w within 1e-3
    (bf16) and 1e-4 (fp32) of kernel 3's, d_loc away from the hat's kinks
    (`bench_v5_kernel.kinks`), where the two formulations take different
    slopes and neither is the gradient.  The benchmark's own v4 gradients
    must equal the kernels' (both kernels are deterministic).  Each kernel,
    kernel 2 or 3 beside it on the same inputs, and its plain version timed
    in both dtypes (plain: median of PLAIN_RUNS).  Every failure is gathered; the phase fails after the last
    case.  Returns ``{kernel: [site records]}``."""
    import torch

    from mm_interleaved_tpu_torch.bench_v5_kernel import kinks
    from mm_interleaved_tpu_torch.ops import ms_deform_attn_v4 as v4mod

    k_dv, k_lw = (kernel_of(name) for name in V4_BWD)
    p_dv, p_lw = (getattr(kmod(name), KERNELS[name]["plain"])
                  for name in V4_BWD)
    ref_dv = kernel_of("ms_deform_attn_bwd_value")
    ref_lw = kernel_of("ms_deform_attn_bwd_loc_weight")
    grads = ("d_value", "d_loc", "d_w")
    sites = {name: [] for name in V4_BWD}
    fails = []
    for case, (value, shapes, loc, w) in res["inputs"].items():
        smooth = ~kinks(loc, shapes)
        recs = {name: dict(site=case, shapes=[list(value.shape),
                                              list(loc.shape)],
                           kinks=int((~smooth).sum()))
                for name in V4_BWD}
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            v = value.to(dt)
            with torch.inference_mode():
                out = v4mod.ms_deform_attn_v4_cuda(v, shapes, loc, w)
                a = (v, shapes, loc, w, (2 * out.float()).to(dt))
                got = (k_dv(*a), *k_lw(*a))
                want = (p_dv(*a), *p_lw(*a))
                ref = (ref_dv(*a), *ref_lw(*a))
                torch.cuda.synchronize()
            if tag == "bf16":
                bench_grads = res["outputs"][case]["v4_grads"]
                for gname, x, y in zip(grads, bench_grads, got):
                    if not torch.equal(x, y):
                        fails.append(f"{case}: the benchmark's {gname} != "
                                     "the kernel's")
            for i, gname in enumerate(grads):
                name = V4_BWD[min(i, 1)]
                g, p_, r = (x.float() for x in (got[i], want[i], ref[i]))
                scale = float(p_.abs().max())
                err = float((g - p_).abs().max())
                if i == 1:  # reported at the kinks, checked away from them
                    recs[name][f"d_loc_err_at_kinks_{tag}"] = float(
                        ((g - r) * ~smooth).abs().max())
                    g, r = g * smooth, r * smooth
                scale1 = float(r.abs().max())
                err1 = float((g - r).abs().max())
                if tag == "bf16":
                    tol = _ulps(scale, 2) if i == 0 else 1e-4 * scale
                    tol1 = (2e-2 if i == 0 else 1e-3) * scale1
                else:
                    tol, tol1 = 1e-5 * scale, 1e-4 * scale1
                if not err <= tol:
                    fails.append(f"{name} {case} {tag} {gname}: kernel vs "
                                 f"plain {err} > {tol}")
                if not err1 <= tol1:
                    fails.append(f"{name} {case} {tag} {gname}: kernel vs "
                                 f"kernels 2/3 {err1} > {tol1}")
                rec = recs[name]
                rec[f"max_abs_err_{tag}"] = max(
                    err, rec.get(f"max_abs_err_{tag}", 0.0))
                rec.update({f"{gname}_err_{tag}": err,
                            f"{gname}_tol_{tag}": tol,
                            f"{gname}_scale_{tag}": scale,
                            f"{gname}_err_vs_kernels23_{tag}": err1,
                            f"{gname}_tol_vs_kernels23_{tag}": tol1})
            for name, kernel, plain, outs, yard, yname in (
                    (V4_BWD[0], k_dv, p_dv, got[:1], ref_dv, "kernel2"),
                    (V4_BWD[1], k_lw, p_lw, got[1:], ref_lw, "kernel3")):
                rec = recs[name]
                with torch.inference_mode():
                    rec[f"ms_{tag}"] = time_ms(lambda: kernel(*a))
                    rec[f"{yname}_ms_{tag}"] = time_ms(lambda: yard(*a))
                    rec[f"plain_ms_{tag}"] = time_ms(lambda: plain(*a),
                                                     PLAIN_RUNS)
                if tag == "bf16":
                    flops, nbytes, rate = WORK[name](a, {}, outs)
                    rec["ops_ms"], rec["bytes_ms"] = _bound(flops, nbytes,
                                                            rate)
                    rec["bound_ms"] = max(rec["ops_ms"], rec["bytes_ms"])
                    rec["bound_by"] = ("operations" if rec["ops_ms"]
                                       > rec["bytes_ms"] else "bytes")
                    rec["flops"], rec["bytes"] = flops, nbytes
                    rec["library_ms"] = None
                    rec["design_ops"] = design_ops(name, a)
            del out, a, got, want, ref
        for name in V4_BWD:
            sites[name].append(recs[name])
            log(f"kernel vs plain and kernels 2/3, {name} {case}: "
                f"{json.dumps(recs[name])}")
        torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return sites


# The v4 gathers (8a, 8b, 8c) at the edges of their corner enumeration:
# whole-texel coordinates (the hat's kinks, the far corner at |t| = 1
# exactly; power-of-two levels, so that loc * size - 0.5 is whole in fp32
# and bf16), corners outside the grid (locations over [-0.2, 1.2], the
# default), every point of a query on one spot (its corners merged onto four
# texels), P = 1, 8, 9 and 64 (4P corners over 32 take 8a's merge across
# rounds; 8b's runs of one query over a round's end carry its sum), non-
# square levels, Q = 300 (off the 32 queries of a CTA), D = 16, 32, 64 and
# 128 in bf16 and fp32 (16, 32, 64 and 128 bytes a row: the 2-, 4-, 8- and
# 16-lane bodies, 32 lanes at fp32 D = 128), bf16 locations, a value view
# off a 16-byte boundary (8a's and 8c's single-element body; 8b, which
# reads no value, is refused a grad_out off one there), fp32 D = 18 (rows
# that are not whole vectors: every kernel's single-element body), and a
# 128 x 128 level (8b's texel table in device memory).  The default levels
# give 8b both walks: a group a texel at 16 x 16, a warp at 8 x 8 and 4 x 4.
V4_EDGES = {
    "kinks_d64": dict(draw="whole"),
    "out_of_grid_d16": dict(D=16),
    "one_spot_d32": dict(D=32, draw="one", P=8),
    "p1_d128": dict(D=128, P=1),
    "p9_nonsquare": dict(P=9, shapes=((12, 16), (6, 8), (3, 5))),
    "p64_d64": dict(P=64, Q=100),
    "bf16_locations": dict(loc_dtype="bfloat16"),
    "bf16_locations_kinks": dict(loc_dtype="bfloat16", draw="whole"),
    "misaligned_value": dict(misaligned=True, P=8),
    "fp32_d16": dict(dtype="float32", D=16),
    "fp32_d32_kinks": dict(dtype="float32", D=32, draw="whole"),
    "fp32_d64_one_spot": dict(dtype="float32", draw="one", P=9),
    "fp32_d128_p64": dict(dtype="float32", D=128, P=64, Q=100),
    "fp32_d18_lanes": dict(dtype="float32", D=18),
    "table_in_device_memory": dict(shapes=((128, 128), (8, 8))),
}


def v4_edge_case(rng, D=64, dtype="bfloat16", loc_dtype="float32",
                 shapes=((16, 16), (8, 8), (4, 4)), P=4, N=2, Q=300, H=4,
                 draw="wide", misaligned=False):
    """``(value, shapes, loc, w, grad_out)`` on the card: locations over
    [-0.2, 1.2], snapped so that each coordinate in texels is whole
    (``whole``), or one spot for all of a query's points (``one``); the
    value a contiguous view 2 elements off a 16-byte boundary with
    ``misaligned``."""
    import torch

    dt, lt = getattr(torch, dtype), getattr(torch, loc_dtype)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    loc = rng.uniform(-0.2, 1.2, (N, Q, H, L, P, 2))
    if draw == "whole":
        for lid, (h, w) in enumerate(shapes):
            for axis, n in ((0, w), (1, h)):
                k = np.floor(loc[:, :, :, lid, :, axis] * n)
                loc[:, :, :, lid, :, axis] = (k + 0.5) / n
    elif draw == "one":
        loc[:] = loc[:, :, :, :, :1]

    def dev(a, t=dt):
        return torch.tensor(a, dtype=t, device="cuda")

    value = dev(rng.randn(N, S, H, D))
    if misaligned:
        buf = torch.empty(value.numel() + 2, dtype=dt, device="cuda")
        value = buf[2:].view(value.shape).copy_(value)
    return (value, shapes, dev(loc, lt), dev(rng.rand(N, Q, H, L, P), lt),
            dev(rng.randn(N, Q, H * D)))


def bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (fp64)."""
    import torch

    a = x.double().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_v4_edges() -> list:
    """Kernels 8a, 8b and 8c at each `V4_EDGES` case against their plain
    versions with the benchmark sites' tolerances (8a and 8b: 2 bf16 ulps
    at the output's scale, fp32 1e-5 of it; 8c: d_loc and d_w within 1e-4
    of their scales in bf16, 1e-5 in fp32; with bf16 locations 8c's
    gradients come back in bf16, and each element is allowed one bf16 ulp
    at its own magnitude beside that, the rounding of the output itself),
    two calls bit-identical; where every coordinate is whole, d_loc exactly
    0 (v4's slopes are 0 there); 8b's plan (body, table, walks) logged, and
    with ``misaligned`` a grad_out off a 16-byte boundary refused before
    any launch.  Every failure is gathered; the phase fails after the last
    case."""
    import torch

    from mm_interleaved_tpu_torch.ops import ms_deform_attn_v4 as v4mod

    k_fwd = kernel_of("ms_deform_attn_v4_fwd")
    k_dv = kernel_of("ms_deform_attn_v4_bwd_value")
    k_lw = kernel_of("ms_deform_attn_v4_bwd_loc_weight")
    plain = {name: getattr(kmod(name), KERNELS[name]["plain"])
             for name in ("ms_deform_attn_v4_fwd", *V4_BWD)}
    recs, fails = [], []
    for i, (name, kw) in enumerate(V4_EDGES.items()):
        tag = f"v4 edge {name}"
        args = v4_edge_case(np.random.RandomState(SEED + 700 + i), **kw)
        value, shapes, loc = args[:3]
        D = value.shape[-1]
        f32 = value.dtype == torch.float32
        plan = v4mod.value_grad_plan(shapes, loc.shape[1], len(shapes),
                                     loc.shape[4], D, value.dtype)
        rec = dict(case=name, value=list(value.shape),
                   loc=list(loc.shape), loc_dtype=str(loc.dtype),
                   rows_in_vectors=(D * value.element_size()) % 16 == 0
                   and value.data_ptr() % 16 == 0,
                   value_grad_plan=plan._asdict())
        with torch.inference_mode():
            got = dict(fwd=((k_fwd(*args[:4]),), (k_fwd(*args[:4]),)),
                       value=((k_dv(*args),), (k_dv(*args),)),
                       loc_weight=(k_lw(*args), k_lw(*args)))
            want = dict(fwd=(plain["ms_deform_attn_v4_fwd"](*args[:4]),),
                        value=(plain["ms_deform_attn_v4_bwd_value"](*args),),
                        loc_weight=plain["ms_deform_attn_v4_bwd_loc_weight"](
                            *args))
            torch.cuda.synchronize()
        for k in ("fwd", "value", "loc_weight"):
            first, again = got[k]
            same = all(bool(torch.equal(a, b)) for a, b in zip(first, again))
            rec[f"bit_identical_{k}"] = same
            if not same:
                fails.append(f"{tag} {k}: two calls differ")
            errs, tols = [], []
            for g, r in zip(first, want[k]):
                scale = float(r.float().abs().max())
                if k in ("fwd", "value"):
                    tol = 1e-5 * scale if f32 else _ulps(scale, 2)
                else:
                    tol = (1e-5 if f32 else 1e-4) * scale
                diff = (g.double() - r.double()).abs()
                if k == "loc_weight" and g.dtype == torch.bfloat16:
                    # gradients returned in bf16 locations' dtype: each
                    # element may round either way of its own fp32 sum
                    diff = (diff - bf16_ulp(r)).clamp_min(0.0)
                err = float(diff.max())
                errs.append(err), tols.append(tol)
                if not err <= tol:
                    fails.append(f"{tag} {k}: {err} > {tol}")
            rec[f"errs_{k}"], rec[f"tols_{k}"] = errs, tols
        if kw.get("draw") == "whole" and bool(got["loc_weight"][0][0].any()):
            fails.append(f"{tag}: d_loc not 0 at whole-texel coordinates")
        if kw.get("misaligned"):
            go = _misaligned(args[4])
            before = k_dv.launches
            try:
                k_dv(*args[:4], go)
                fails.append(f"{tag}: 8b took a misaligned grad_out")
            except ValueError as e:
                rec["refused_8b"] = str(e)
            if k_dv.launches != before:
                fails.append(f"{tag}: 8b counted a refused call")
        recs.append(rec)
        log(f"v4 edge case: {json.dumps(rec)}")
        del got, want, args
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    return recs


def run_v5_bench_phase() -> list:
    """Phase 10: the v4-against-v5 benchmark entry point on the card with
    every count at 0 just before it: each kernel of its path launched
    exactly as often as the calls that reach it, every other kernel not at
    all; each row finite, with v4 within 2e-2 of v5 in the forward and in
    every gradient (the bf16 tolerance of tests/test_torch_v4_backward.py);
    then `compare_v4_backward` and `check_v4_edges`.  Returns the kernels line's entries of 8b
    and 8c."""
    from mm_interleaved_tpu_torch import bench_v5_kernel as bench

    reset_counts()
    t0 = time.perf_counter()
    res = bench.run("cuda")
    got = read_counts()
    log(f"bench_v5_kernel.run: {time.perf_counter() - t0:.1f} s")
    fails = []
    for row in res["rows"]:
        log(f"bench_v5_kernel: {json.dumps(row)}")
        if not row["finite"]:
            fails.append(f"{row['case']}: non-finite output or gradient")
        for key in ("fwd", "d_value", "d_loc", "d_w"):
            if not row[f"rel_diff_{key}"] <= 2e-2:
                fails.append(f"{row['case']}: v4 vs v5 {key} "
                             f"{row[f'rel_diff_{key}']} > 2e-2")
    want = dict.fromkeys(KERNELS, 0)
    for name, calls in V5_BENCH_LAUNCHES.items():
        want[name] = sum(res["calls"][c] for c in calls)
    if got != want or 0 in (want[n] for n in V5_BENCH_LAUNCHES):
        fails.append(f"launches in the benchmark {got}, calls made {want}")
    if fails:
        raise AssertionError(f"{len(fails)} failed checks: {fails}")
    log(f"v5 benchmark launches {json.dumps(got)}")
    t0 = time.perf_counter()
    sites = compare_v4_backward(res)
    log(f"compare_v4_backward: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_v4_edges()
    log(f"check_v4_edges: {time.perf_counter() - t0:.1f} s")
    return [kernel_line(name, sites[name], got[name],
                        timing="sum over the v4-against-v5 benchmark's four "
                               "cases")
            for name in V4_BWD]


# --------------------------------------------------------------------------
# the entry points (phases 11-13)

SMOKE_TRAIN_STEPS = 3
# the kernels that every training step launches
TRAIN_KERNELS = ("ms_deform_attn_fwd", "flash_attention_fwd", *GN, *BACKWARD)


class Killed(Exception):
    """Ends a run of the training entry point mid-step (phase 11)."""


def smoke_train_config(name: str, model: dict, **training) -> str:
    """``build/<name>.yaml``: `configs/pretrain_synthetic.yaml` with
    ``model`` and the ``training`` keys given, 2 rows a batch."""
    import yaml

    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    with open("configs/pretrain_synthetic.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["model"] = model
    cfg["training"].update(training)
    cfg["data"]["per_device_batch_size"] = 2
    path = BUILD_DIR.parent / f"{name}.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def train_entry(config: str, out_dir: str, kill_at=None) -> dict:
    """`train.main` on the card into ``out_dir``, killed before step
    ``kill_at + 1`` when ``kill_at`` is given."""
    from mm_interleaved_tpu_torch import train
    from mm_interleaved_tpu_torch.engine.trainer import Trainer

    step = Trainer.train_step

    def killable(self, batch, draws=None):
        if self.step == kill_at:
            raise Killed
        return step(self, batch, draws)

    Trainer.train_step = killable
    try:
        return train.main(["--config", config, "--output_dir", out_dir,
                           "--device", "cuda"])
    finally:
        Trainer.train_step = step


def check_resume() -> dict:
    """The tiny preset through the training entry point on the card: 3
    steps uninterrupted; then a run killed in step 3, resumed from its
    step-2 checkpoint.  Step 3's metrics, masters and moments must be the
    uninterrupted run's, bit for bit."""
    import torch

    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    cfg = smoke_train_config("smoke_resume", {"preset": "tiny"},
                             save_steps=2, max_steps=3)
    root = BUILD_DIR.parent / "smoke_resume"
    shutil.rmtree(root, ignore_errors=True)
    a = train_entry(cfg, str(root / "a"))
    try:
        train_entry(cfg, str(root / "b"), kill_at=2)
        raise AssertionError("the killed run did not stop")
    except Killed:
        pass
    saved = sorted(p.name for p in (root / "b" / "checkpoints").iterdir())
    if saved != ["step_2.pt"]:
        raise AssertionError(f"killed run's checkpoints {saved}")
    b = train_entry(cfg, str(root / "b"))
    if [s for s, _ in b["logged"]] != [3]:
        raise AssertionError(f"resumed run logged {b['logged']}")
    m_a, m_b = a["logged"][-1][1], b["logged"][-1][1]
    keys = ("loss", "grad_norm", "loss_txt", "loss_img")
    same = {k: m_a[k] == m_b[k] for k in keys}
    sa = torch.load(a["checkpoint"], weights_only=False)
    sb = torch.load(b["checkpoint"], weights_only=False)
    same["masters"] = all(torch.equal(x, sb["params"][n])
                          for n, x in sa["params"].items())
    same["moments"] = all(torch.equal(x, sb["opt_state"][k][n])
                          for k in ("m", "v")
                          for n, x in sa["opt_state"][k].items())
    same["data_state"] = sa["data_state"] == sb["data_state"]
    if not all(same.values()):
        raise AssertionError(f"resumed step 3 differs: {same}; "
                             f"{ {k: (m_a[k], m_b[k]) for k in keys} }")
    shutil.rmtree(root, ignore_errors=True)
    return dict(same=same, step3={k: m_a[k] for k in keys},
                data_state=sa["data_state"])


def run_train_entry() -> dict:
    """Phase 11: `train.main` on the flagship (2 rows of 256 tokens, 2
    image slots a row, 512 px targets) from the YAML, 3 steps with every
    count at 0 just before it (the zero-initialised leaves perturbed as in
    phase 8 when the fit starts); then `check_resume`.  Raises on any
    failed check."""
    import torch

    from mm_interleaved_tpu_torch.data import native
    from mm_interleaved_tpu_torch.data.pipeline import build_train_iterator
    from mm_interleaved_tpu_torch.engine.trainer import Trainer
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR
    from mm_interleaved_tpu_torch.utils.config import (build_model_config,
                                                       load_config)

    t_phase = time.perf_counter()
    model = {"preset": "flagship",
             "overrides": {"seq_len": 256, "max_num_images": 2}}
    config = smoke_train_config("smoke_train", model, warmup_steps=0,
                                max_steps=SMOKE_TRAIN_STEPS)
    cfg = load_config(config)
    model_cfg = build_model_config(cfg["model"])
    # the data path alone: the batches the run takes and their host time
    it, _ = build_train_iterator(cfg["data"], model_cfg)
    host_ms, images = [], []
    for _ in range(SMOKE_TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = next(it)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        images.append(batch["image_tensors"].shape[0]
                      * batch["image_tensors"].shape[1])
    per_step = [expected_train_launches(model_cfg, n) for n in images]
    expected = {k: sum(e[k] for e in per_step) for k in KERNELS}

    snap = dict(step_ms=[])
    fit, step = Trainer.fit, Trainer.train_step

    def snapshot_fit(self, *a, **kw):
        # as phase 8: the zero-initialised gates and offsets would leave
        # the deformable branches without gradient; the masters follow
        perturb_zero_inits(self.model, SEED + 1)
        with torch.no_grad():
            for p, x in zip(self.optimizer.params, self.optimizer.masters):
                if x is not p.data:
                    x.copy_(p.detach().float())
        params = dict(self.model.named_parameters())
        snap["frozen"] = {n: p.detach().to("cpu", copy=True)
                          for n, p in params.items() if not p.requires_grad}
        snap["start"] = [p.detach().to("cpu", copy=True)
                         for p in self.optimizer.params]
        torch.cuda.reset_peak_memory_stats()
        return fit(self, *a, **kw)

    def timed_step(self, batch, draws=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(self, batch, draws)
        torch.cuda.synchronize()
        snap["step_ms"].append((time.perf_counter() - t0) * 1e3)
        return m

    out_dir = BUILD_DIR.parent / "smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    free_gb = shutil.disk_usage(BUILD_DIR.parent).free / 1e9
    Trainer.fit, Trainer.train_step = snapshot_fit, timed_step
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = train_entry(config, str(out_dir))
    finally:
        Trainer.fit, Trainer.train_step = fit, step
    launches = read_counts()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trainer = res.pop("trainer")
    opt = trainer.optimizer
    logged = res["logged"]
    if [s for s, _ in logged] != list(range(1, SMOKE_TRAIN_STEPS + 1)):
        raise AssertionError(f"step lines {logged}")
    for _, m in logged:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training metrics {m}")
        if not m["loss_img"] > 0:  # the batches' images reach the decoder
            raise AssertionError(f"no image loss: {m}")
    if launches != expected:
        raise AssertionError(f"train entry launches {launches} != "
                             f"{expected} (images a step {images})")
    params = dict(trainer.model.named_parameters())
    for n, t in snap.pop("frozen").items():
        if not torch.equal(params[n].detach(), t.to(params[n].device)):
            raise AssertionError(f"frozen parameter {n} changed")
    moved = {}
    for lab, x, x0 in zip(opt.labels, opt.masters, snap.pop("start")):
        d = float((x - x0.to(x.device).float()).abs().max())
        moved[lab] = max(moved.get(lab, 0.0), d)
    if not all(d > 0 for d in moved.values()):
        raise AssertionError(f"a trainable group did not move: {moved}")
    n_train = sum(x.numel() for x in opt.masters)
    del trainer, opt, params
    torch.cuda.empty_cache()
    ckpt = Path(res["checkpoint"])
    if ckpt.name != f"step_{SMOKE_TRAIN_STEPS}.pt" or not ckpt.exists():
        raise AssertionError(f"final checkpoint {ckpt}")
    shutil.rmtree(out_dir, ignore_errors=True)
    t_resume = time.perf_counter()
    resume = check_resume()
    return dict(logged=logged, step_ms=snap["step_ms"], launches=launches,
                per_step=per_step, images=images, host_ms=host_ms,
                native=native.is_available(), peak_gb=peak_gb,
                trainable=n_train, moved=moved, run_s=run_s,
                checkpoint_gb=res["checkpoint_bytes"] / 1e9, free_gb=free_gb,
                save_s=res["save_s"], resume=resume,
                resume_s=time.perf_counter() - t_resume,
                wall_s=time.perf_counter() - t_phase)


def bench_text_launches(cfg, n_decode: int) -> dict:
    """Each kernel's launches in `bench.text_half` (the text slice's
    derivation): the adapter's deformable calls and the LLM's MMFS layers
    at the prefill and each later token; the visual tokenizer's mask-free
    attention."""
    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    out = dict.fromkeys(KERNELS, 0)
    out["ms_deform_attn_fwd"] = (2 * adapter.num_interactions
                                 + adapter.extra_extractors
                                 + n_cross * n_decode)
    out["flash_attention_fwd"] = encoder_flash_calls(cfg)
    return out


# the bench turns phase 12 times (the benchmark's default is 3; the smoke
# checks the path, the benchmark PR measures it)
BENCH_TURNS = 1


def run_bench_turn() -> dict:
    """Phase 12: `bench.run("cuda")` at its defaults but ``BENCH_TURNS``
    timed turns, with every count at 0
    just before it: its line's values finite and positive, both
    utilisation estimates under 1.05, and every kernel's launches equal to
    the count derived from the base config for its warm-up and timed
    turns and its throughput decodes.  One turn's launches are read in a
    window of their own, the counts read just before the first timed
    turn's `text_half` and just after its `image_half`, and must equal
    the turn's derived count."""
    import torch

    from mm_interleaved_tpu_torch import bench

    reps, B, n_decode, n_denoise = BENCH_TURNS, 2, 32, 25
    cfg = bench.PRESETS["base"]()
    text = bench_text_launches(cfg, n_decode)
    image = expected_image_launches(cfg, n_denoise, B)
    derived = {k: text[k] + image[k] for k in KERNELS}
    expected = {k: (1 + reps) * (derived[k] + text[k]) for k in KERNELS}
    text_half, image_half = bench.text_half, bench.image_half
    calls, window = {"text": 0, "image": 0}, {}

    def windowed_text(*a, **kw):
        calls["text"] += 1
        if calls["text"] == 2:  # the first timed turn (after the warm-up)
            window["before"] = read_counts()
        return text_half(*a, **kw)

    def windowed_image(*a, **kw):
        out = image_half(*a, **kw)
        calls["image"] += 1
        if calls["image"] == 2:
            window["after"] = read_counts()
        return out

    bench.text_half, bench.image_half = windowed_text, windowed_image
    os.environ["BENCH_REPS"] = str(reps)
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = bench.run("cuda")
    finally:
        bench.text_half, bench.image_half = text_half, image_half
        del os.environ["BENCH_REPS"]
    launches = read_counts()
    wall_s = time.perf_counter() - t0
    turn = {k: window["after"][k] - window["before"][k] for k in KERNELS}
    bad = {k: v for k, v in res.items() if isinstance(v, (int, float))
           and not (np.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"bench values not finite and positive: {bad}")
    for k in ("decode_hbm_util_est", "decode_mfu_est"):
        if not res[k] < 1.05:
            raise AssertionError(f"bench {k} {res[k]} >= 1.05")
    if launches != expected:
        raise AssertionError(f"bench launches {launches} != {expected}")
    if turn != derived:
        raise AssertionError(f"one bench turn launched {turn} != {derived}")
    for name in ("ms_deform_attn_fwd", "ms_deform_attn_mi_fwd",
                 "flash_attention_fwd", *GN, "geglu_fwd"):
        if turn[name] == 0:
            raise AssertionError(f"{name} not on the bench turn")
    torch.cuda.empty_cache()
    return dict(line=res, turn=turn, launches=launches, wall_s=wall_s)


def run_bench_train() -> dict:
    """Phase 13: `bench_train.run("cuda")`, small and base sections, 2
    timed steps each, with every count at 0 just before it: its values
    finite and positive, a measured base full step, each kernel of the
    training step launched."""
    import os

    import torch

    from mm_interleaved_tpu_torch import bench_train

    os.environ["BENCH_TRAIN_REPS"] = "2"
    reset_counts()
    t0 = time.perf_counter()
    res = bench_train.run("cuda")
    launches = read_counts()
    wall_s = time.perf_counter() - t0
    bad = {k: v for k, v in res.items() if isinstance(v, (int, float))
           and not (np.isfinite(v) and v > 0)}
    if bad or "base_full_step_ms" not in res:
        raise AssertionError(f"bench_train values: {bad or res}")
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"bench_train launched no {missing}")
    torch.cuda.empty_cache()
    return dict(line=res, launches=launches, wall_s=wall_s)


# --------------------------------------------------------------------------
# the serving path (phase 14)

# the evaluator's caption and VQA defaults (`evaluate.REF_TASK_DEFAULTS`)
CAPTION_BEAM = dict(max_new_tokens=20, min_new_tokens=8, num_beams=5,
                    length_penalty=1.0)
VQA_BEAM = dict(max_new_tokens=10, min_new_tokens=0, num_beams=3,
                length_penalty=0.0)
# denoise steps of the serving phases' image turns and routes (14, 16d);
# the path is the same at any count
SERVE_STEPS = 10
# the grounding route decodes 24 greedy tokens; `generate_scores` runs the
# options in chunks of 4 rows; the synthetic VisDial rows have 4 options
GROUNDING_TOKENS = 24
SCORES_MINI_BS = 4
VISDIAL_OPTIONS = 4


def add_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def scale_launches(counts, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def scores_launches(cfg, chunks: int) -> dict:
    """`generate_scores` over ``chunks`` chunks: each encodes its images
    (the adapter's deformable calls, the visual tokenizer's attention) and
    runs the cache-free LLM forward (every MMFS layer, every layer's
    mask-free attention)."""
    adapter = cfg.visual.encoder
    n_cross = cfg.llm.num_hidden_layers // cfg.llm.cross_attention_frequency
    out = dict.fromkeys(KERNELS, 0)
    out["ms_deform_attn_fwd"] = chunks * (2 * adapter.num_interactions
                                          + adapter.extra_extractors
                                          + n_cross)
    out["flash_attention_fwd"] = chunks * (encoder_flash_calls(cfg)
                                           + cfg.llm.num_hidden_layers)
    return out


def clip_feature_launches(vit_cfg, calls: int) -> dict:
    """``calls`` batches through `utils.fid.CLIPViTFeatures` of a ViT of
    ``vit_cfg``: its layers' mask-free attention."""
    out = dict.fromkeys(KERNELS, 0)
    out["flash_attention_fwd"] = calls * vit_cfg.num_hidden_layers
    return out


def timed(fn, *a, **kw):
    """``(fn(*a, **kw), ms, launches)``, synchronised, the launches read in
    a window of the call's own."""
    import torch

    torch.cuda.synchronize()
    before = read_counts()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = read_counts()
    return out, ms, {k: after[k] - before[k] for k in KERNELS}


def run_serving_beam(model, greedy_tokens) -> dict:
    """Phase 14a: `generate_texts` with beam search on the phase 5 prompt
    (B = 2) at the caption defaults (K = 5, 20 tokens, min 8, alpha 1) and
    the VQA defaults (K = 3, 10 tokens, alpha 0): tokens in vocabulary, two
    runs identical, kernel 1's launches the derived count; ms/token beside
    greedy's at the same settings (the 1-token run subtracted), peak memory
    of each; then K = 1 beam search against phase 5's greedy tokens."""
    import torch

    from mm_interleaved_tpu_torch.generation.beam import beam_search
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)

    cfg = model.cfg
    s = cfg.special
    ids, images, n_img, att = prompt_inputs(cfg, "cuda")
    out = {}
    for name, kw in (("caption", CAPTION_BEAM), ("vqa", VQA_BEAM)):
        gen = TextGenerationConfig(
            eos_token_ids=(s.eos_token_id, s.soi_token_id),
            pad_token_id=s.pad_token_id, **kw)
        T = gen.max_new_tokens
        res = {}
        for mode, g in (("beam", gen),
                        ("greedy", dataclasses.replace(gen, num_beams=1))):
            generate_texts(model, ids, images, n_img, att,
                           dataclasses.replace(g, max_new_tokens=2))
            _, first_ms, _ = timed(generate_texts, model, ids, images, n_img,
                                   att, dataclasses.replace(g,
                                                            max_new_tokens=1))
            torch.cuda.reset_peak_memory_stats()
            tokens, ms, launches = timed(generate_texts, model, ids, images,
                                         n_img, att, g)
            res[mode] = dict(tokens=tokens, ms=ms, first_ms=first_ms,
                             ms_per_token=(ms - first_ms) / (T - 1),
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                             launches=launches)
        tokens = res["beam"]["tokens"]
        again = generate_texts(model, ids, images, n_img, att, gen)
        if tuple(tokens.shape) != (B, T):
            raise AssertionError(f"{name} beam tokens {tuple(tokens.shape)}")
        if not ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all():
            raise AssertionError(f"{name} beam tokens out of vocabulary")
        if not torch.equal(tokens, again):
            raise AssertionError(f"two {name} beam runs differ")
        want = bench_text_launches(cfg, T)
        for mode in res:
            if res[mode]["launches"] != want:
                raise AssertionError(f"{name} {mode} launches "
                                     f"{res[mode]['launches']} != {want}")
        out[name] = dict(
            num_beams=gen.num_beams, new_tokens=T,
            tokens=tokens[:, :8].tolist(),
            **{f"{m}_{k}": r[k] for m, r in res.items()
               for k in ("ms", "first_ms", "ms_per_token", "peak_gb")},
            launches=res["beam"]["launches"])
    one = TextGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    with torch.inference_mode():
        prep = model.prepare_mm_embeds(ids, images, n_img)
    k1 = beam_search(model, prep["mm_embeds"], att, prep["mmfs_values"],
                     prep["cross_attention_mask"], one)
    if not torch.equal(k1, greedy_tokens):
        raise AssertionError(f"K = 1 beam tokens differ from phase 5's "
                             f"greedy: {k1[:, :8]} vs {greedy_tokens[:, :8]}")
    out["k1_equals_greedy"] = True
    return out


@contextlib.contextmanager
def recording(cls, names, calls):
    """Each method ``names`` of ``cls`` timed (`timed`), appending ``(name,
    ms, launches)`` to ``calls``; restored on exit."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def method(self, *a, **kw):
            result, ms, launches = timed(fn, self, *a, **kw)
            calls.append((name, ms, launches))
            return result
        return method

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def run_serving_inference(model) -> dict:
    """Phase 14b: `inference.main` on ``build/smoke_inference.yaml``
    (`configs/inference.yaml` at the flagship, 3 turns, an image forced
    after each text turn, `SERVE_STEPS` steps) over an annt.json of two
    synthetic jpgs: a text, image, text run whose PNG decodes to the
    decoder's size; each turn's wall and launches against the derived
    counts (a text turn:
    the encoder, the prefill and ``max_new_tokens - 1`` decode steps; an
    image turn: `expected_image_launches` for one row)."""
    import torch
    import yaml
    from PIL import Image

    from mm_interleaved_tpu_torch import inference
    from mm_interleaved_tpu_torch.data.synthetic_eval import (
        write_inference_assets)
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR
    from mm_interleaved_tpu_torch.parallel.inference import LocalGenerator

    root = BUILD_DIR.parent / "smoke_inference"
    shutil.rmtree(root, ignore_errors=True)
    annt = write_inference_assets(str(root / "inputs"))
    with open("configs/inference.yaml") as f:
        config = yaml.safe_load(f)
    config["model"] = {"preset": "flagship"}
    config["inference"].update(num_iter=3, force_image_every_turn=True,
                               num_inference_steps=SERVE_STEPS)
    path = BUILD_DIR.parent / "smoke_inference.yaml"
    path.write_text(yaml.safe_dump(config))
    calls = []
    params = {n: int(_digest(p)) for n, p in model.named_parameters()}
    traced, margins = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recording(LocalGenerator, ("generate_texts", "generate_image_inputs",
                                    "denoise"), calls), \
            turn_trace(model, traced, margins) as stop:
        gen = LocalGenerator.generate_texts  # the recorded one

        def first_turn_traced(self, *a, **kw):
            try:
                return gen(self, *a, **kw)
            finally:
                stop()

        LocalGenerator.generate_texts = first_turn_traced
        try:
            res = inference.main(["--config", str(path), "--annt_path", annt,
                                  "--image_root", str(root / "inputs"),
                                  "--output_dir", str(root / "out"),
                                  "--device", "cuda"], model=model)
        finally:
            LocalGenerator.generate_texts = gen
    wall_s = time.perf_counter() - t0
    turn = dict(text=res["results"][0]["texts"][0], params=params,
                **trace_record(traced, margins))
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = model.cfg
    text = bench_text_launches(cfg, config["inference"]["max_new_tokens"])
    image = expected_image_launches(cfg, SERVE_STEPS, 1)
    turns = []
    for name, ms, counts in calls:
        if name == "denoise":
            turns[-1]["ms"] += ms
            turns[-1]["launches"] = add_launches(turns[-1]["launches"],
                                                 counts)
        else:
            turns.append(dict(kind="text" if name == "generate_texts"
                              else "image", ms=ms, launches=counts))
    if [t["kind"] for t in turns] != ["text", "image", "text"]:
        raise AssertionError(f"inference turns {[t['kind'] for t in turns]}")
    for t in turns:
        want = text if t["kind"] == "text" else image
        if t["launches"] != want:
            raise AssertionError(f"inference {t['kind']} turn launched "
                                 f"{t['launches']} != {want}")
    if launches != add_launches(text, image, text):
        raise AssertionError(f"inference launches {launches}")
    if len(res["images"]) != 1 or len(res["results"][0]["texts"]) != 2:
        raise AssertionError(f"inference results {res['results']}")
    png = np.asarray(Image.open(res["images"][0]))
    size = cfg.image_decoder.image_size
    if png.shape != (size, size, 3):
        raise AssertionError(f"inference PNG {png.shape}")
    return dict(turns=[{"kind": t["kind"], "ms": t["ms"]} for t in turns],
                turn_record=turn,
                texts=res["results"][0]["texts"], png_shape=list(png.shape),
                launches=launches, text_turn=text, image_turn=image,
                peak_gb=peak_gb, wall_s=wall_s)


def _digest(t):
    """An int64 digest of a tensor's bits (on its device, no sync)."""
    import torch

    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    x = t.detach().contiguous().reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if x.is_floating_point():
        x = x.view(bits[x.element_size()])
    v = x.to(torch.int64)
    return v.sum() + 31 * (v * v).sum()


def _aligns(obj):
    """Each tensor's data pointer modulo 256 (a GEMM takes another kernel
    for an input off a 16-byte boundary)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj.data_ptr() % 256]
    if isinstance(obj, (tuple, list)):
        return [a for o in obj for a in _aligns(o)]
    return []


def _digests(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return [_digest(obj)]
    if isinstance(obj, (tuple, list)):
        return [d for o in obj for d in _digests(o)]
    if isinstance(obj, dict):
        return [d for k in sorted(obj) for d in _digests(obj[k])]
    return []


# the digest (sha256, first 16 hex digits) of the native image kernel's
# pixels on a seeded image (`native_pixels`), as the CPU computes them: a
# host whose build computes other pixels fails phase 14d
NATIVE_PIXELS = "c2bd2af92f231119"


def native_pixels() -> str:
    """The digest of `data.native.crop_resize_to_f32` on a seeded 480 x 640
    image, cropped and resized to 448 px, on this host's build."""
    import hashlib

    from mm_interleaved_tpu_torch.data import native

    if not native.is_available():
        raise AssertionError("the native image kernels did not build")
    rs = np.random.RandomState(0)
    src = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    out = native.crop_resize_to_f32(src, 10, 20, 460, 600, 448, 448)
    return hashlib.sha256(out.tobytes()).hexdigest()[:16]


def probe_config_path() -> tuple:
    """Phase 14b's YAML and inputs cut to its first text turn: returns
    ``(yaml path, annt path, image root)`` under ``build/``."""
    import yaml

    from mm_interleaved_tpu_torch.data.synthetic_eval import (
        write_inference_assets)
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    root = BUILD_DIR.parent / "smoke_turn_probe"
    annt = write_inference_assets(str(root / "inputs"))
    with open("configs/inference.yaml") as f:
        config = yaml.safe_load(f)
    config["model"] = {"preset": "flagship"}
    config["inference"].update(num_iter=1)
    path = root / "turn.yaml"
    path.write_text(yaml.safe_dump(config))
    return str(path), annt, str(root / "inputs")


@contextlib.contextmanager
def turn_trace(model, calls: list, margins: list):
    """While open (or until the ``stop`` it yields is called): in call
    order in ``calls``, each module's inputs' alignments (`_aligns`) and
    its output's digest, and the digests of the inputs and outputs of
    every kernel call and of the LLM's rotary embedding and attention
    (plain where a dense mask is given, as in the KV-cache prefill); each
    text-head call's top-2 margin at its last position in ``margins``."""
    from mm_interleaved_tpu_torch.models import llama
    from mm_interleaved_tpu_torch.ops import cuda_build

    hooks = [mod.register_forward_hook(
        lambda m, a, o, name=name: calls.append(
            (name, _aligns(a), _digests(o))))
        for name, mod in model.named_modules()]
    funcs = {n: getattr(llama, n) for n in ("apply_rotary_embedding",
                                            "dot_product_attention")}

    def traced(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            calls.append((name, _digests(list(a)) + _aligns(list(a)),
                          _digests(out)))
            return out
        return call

    for n, fn in funcs.items():
        setattr(llama, n, traced(n, fn))
    hooks.append(model.text_decoder.register_forward_hook(
        lambda m, a, o: margins.append(
            (lambda t: t[0] - t[1])(o[0, -1].float().topk(2).values))))
    launch = cuda_build.CountedKernel.__call__

    def counted(self, *a, **kw):
        out = launch(self, *a, **kw)
        calls.append((getattr(self._launch, "__name__", "kernel"),
                      _digests(list(a)), _digests(out)))
        return out

    def stop():
        cuda_build.CountedKernel.__call__ = launch
        for n, fn in funcs.items():
            setattr(llama, n, fn)
        for h in hooks:
            h.remove()
        hooks.clear()

    cuda_build.CountedKernel.__call__ = counted
    try:
        yield stop
    finally:
        stop()


def trace_record(calls: list, margins: list) -> dict:
    import torch

    torch.cuda.synchronize()
    return dict(margins=[float(m) for m in margins],
                calls=[(n, [int(x) for x in a], [int(x) for x in o])
                       for n, a, o in calls])


def turn_probe_main(out_path: str) -> int:
    """``chip_smoke.py --turn-probe OUT``: in this fresh process, the
    flagship of phase 14 (its seeded weights, bf16), then the inference
    entry point's first text turn (64 greedy tokens) on phase 14b's
    inputs.  Saves to ``OUT``: the turn's text, a
    digest of every parameter and `turn_trace`'s record of the turn (the
    first call of each name is the prefill)."""
    import torch

    from mm_interleaved_tpu_torch import inference
    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(flagship_config(), "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    params = {n: int(_digest(p)) for n, p in model.named_parameters()}
    calls, margins = [], []
    path, annt, root = probe_config_path()
    with turn_trace(model, calls, margins):
        res = inference.main(["--config", path, "--annt_path", annt,
                              "--image_root", root, "--output_dir",
                              str(Path(path).parent / "out"), "--device",
                              "cuda"], model=model)
    torch.save(dict(text=res["results"][0]["texts"][0], params=params,
                    **trace_record(calls, margins)), out_path)
    return 0


def compare_turns(here: dict, fresh: dict) -> dict:
    """Phase 14b's first text turn in this process against the same turn
    in a fresh process (`turn_probe_main`): the texts, the parameters'
    digests, the first traced call that differs with its inputs' record in
    both processes (digests and alignments, or a module's alignments) and
    the calls before it."""
    out = dict(text_here=here["text"], text_fresh=fresh["text"],
               equal=here["text"] == fresh["text"],
               params_differ=sorted(n for n, d in fresh["params"].items()
                                    if here["params"].get(n) != d)[:8])
    n = min(len(here["calls"]), len(fresh["calls"]))
    first = next((i for i in range(n)
                  if here["calls"][i] != fresh["calls"][i]), None)
    out["calls_compared"] = n
    if first is not None:
        a, b = here["calls"][first], fresh["calls"][first]
        out["first_differing_call"] = dict(
            index=first, name=a[0], fresh_name=b[0],
            inputs=dict(here=a[1], fresh=b[1]),
            previous=[c[0] for c in here["calls"][max(0, first - 4):first]])
    out["margins"] = dict(here=here["margins"][:4], fresh=fresh["margins"][:4])
    return out


EVAL_ROUTES = ("evaluate_caption", "evaluate_vqa", "evaluate_ranking",
               "evaluate_grounding", "evaluate_t2i", "evaluate_storytelling")


def eval_route_launches(cfg) -> dict:
    """Each route's launches on one batch of 2 rows (the synthetic files of
    `data.synthetic_eval`): the caption and VQA beams, the ranking chunks,
    grounding's greedy tokens; t2i's image inputs and denoise (one
    candidate) and storytelling's two rounds, each image route's CLIP
    features of its generated and its ground-truth images."""
    image = expected_image_launches(cfg, SERVE_STEPS, B)
    clip = clip_feature_launches(cfg.visual.encoder.vit, 2)
    chunks = -(-B * VISDIAL_OPTIONS // SCORES_MINI_BS)
    return {
        "evaluate_caption": bench_text_launches(
            cfg, CAPTION_BEAM["max_new_tokens"]),
        "evaluate_vqa": bench_text_launches(cfg, VQA_BEAM["max_new_tokens"]),
        "evaluate_ranking": scores_launches(cfg, chunks),
        "evaluate_grounding": bench_text_launches(cfg, GROUNDING_TOKENS),
        "evaluate_t2i": add_launches(image, clip),
        "evaluate_storytelling": add_launches(scale_launches(image, 2), clip),
    }


def run_serving_eval(model) -> dict:
    """Phase 14c: `evaluate.main` on ``build/smoke_eval.yaml``: the six
    routes of `data.synthetic_eval` (COCO captions with 5 beams, VQA with
    3, VisDial ranking over 4 options, grounding, COCO text to image at 25
    steps with CLIP-FID, storytelling over two rounds) at the flagship, 2
    rows a batch, one batch each: one finite ``eval_metrics.jsonl`` row a
    route, each route's launches the derived count, its samples/s."""
    import torch
    import yaml

    from mm_interleaved_tpu_torch import evaluate
    from mm_interleaved_tpu_torch.data.synthetic_eval import write_eval_assets
    from mm_interleaved_tpu_torch.engine.evaluator import Evaluator
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    root = BUILD_DIR.parent / "smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    val = write_eval_assets(str(root / "data"), n=B,
                            n_options=VISDIAL_OPTIONS)
    config = dict(output_dir=str(root / "out"), model={"preset": "flagship"},
                  data=dict(tokenizer_path=None, val=val),
                  evaluation=dict(batch_size=B, max_batches=1, clip_fid=True,
                                  num_inference_steps=SERVE_STEPS))
    path = BUILD_DIR.parent / "smoke_eval.yaml"
    path.write_text(yaml.safe_dump(config))
    calls = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recording(Evaluator, EVAL_ROUTES, calls):
        results = evaluate.main(["--config", str(path), "--device", "cuda"],
                                model=model)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rows = [json.loads(x) for x in
            (root / "out" / "eval_metrics.jsonl").read_text().splitlines()]
    names = [s["dataset_name"] for s in val]
    if [r["dataset"] for r in rows] != names or list(results) != names:
        raise AssertionError(f"eval rows {[r['dataset'] for r in rows]}")
    if [c[0] for c in calls] != list(EVAL_ROUTES):
        raise AssertionError(f"eval routes {[c[0] for c in calls]}")
    want = eval_route_launches(model.cfg)
    routes = {}
    for (route, ms, launches), row in zip(calls, rows):
        nums = [v for v in row.values() if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if not all(np.isfinite(nums)):
            raise AssertionError(f"non-finite eval row {row}")
        if launches != want[route]:
            raise AssertionError(f"{route} launched {launches} != "
                                 f"{want[route]}")
        n = row.get("num_samples", row.get("num_generated"))
        if not n:
            raise AssertionError(f"eval row without samples {row}")
        routes[route] = dict(dataset=row["dataset"], ms=ms, samples=n,
                             samples_per_s=n / (ms / 1e3),
                             row={k: v for k, v in row.items()
                                  if k not in ("dataset", "time",
                                               "image_dir")})
    return dict(routes=routes, launches=add_launches(*(c[2] for c in calls)),
                peak_gb=peak_gb, wall_s=wall_s)


def run_serving(greedy_tokens) -> dict:
    """Phase 14: the flagship with its image decoder, bf16, seeded weights
    (phase 4's: the same seed and config but for ``max_num_images``, which
    shapes no weight), built again after the earlier phases freed theirs,
    then 14a, 14b and 14c on that one build."""
    import gc

    import torch

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(flagship_config(), "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    beam = run_serving_beam(model, greedy_tokens)
    inf = run_serving_inference(model)
    ev = run_serving_eval(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    turn = run_turn_probe(inf.pop("turn_record"))
    return dict(build_s=build_s, beam=beam, inference=inf, eval=ev,
                turn=turn, wall_s=time.perf_counter() - t0)


def run_turn_probe(here: dict) -> dict:
    """Phase 14d: this host's build of the native image kernels computes
    the CPU's pixels (`NATIVE_PIXELS`: the first turn's image tensors, and
    its tied greedy token, followed the machine that built the library,
    ROADMAP.md §3); then the inference entry's first text turn again, in a
    fresh process (``chip_smoke.py --turn-probe``), against phase 14b's in
    this one (`compare_turns`): the texts must be equal; where the traced
    records part, the first differing call is logged."""
    import subprocess

    import torch

    pixels = native_pixels()
    if pixels != NATIVE_PIXELS:
        raise AssertionError(f"14d: this host's native image kernels give "
                             f"pixels {pixels}, the CPU's {NATIVE_PIXELS}")
    out = Path("build/smoke_turn_probe")
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out / "fresh.log", "w") as f:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--turn-probe", str(out / "fresh.pt")],
                            stdout=f, stderr=subprocess.STDOUT,
                            timeout=TP_TIMEOUT).returncode
    if rc:
        raise AssertionError(f"14d: the fresh process exited {rc}: see "
                             f"{out}/fresh.log")
    res = compare_turns(here, torch.load(out / "fresh.pt",
                                         weights_only=False))
    res.update(native_pixels=pixels, wall_s=time.perf_counter() - t0)
    if not res["equal"]:
        raise AssertionError(f"14d: the first turn differs between two "
                             f"processes: {json.dumps(res)}")
    return res


# weights from files (phase 15)

# the LLM's depth in phase 15: 4 layers, layer 0 the MMFS layer (the
# flagship has 40); every other width and depth is the flagship's
WEIGHT_LAYERS = 4
WEIGHT_TOKENS = 8
WEIGHT_STEPS = 5
WEIGHT_SHARDS = 2
CLIP_CAPTIONS = 16
CLIP_CANDIDATES = 2
INCEPTION_IMAGES = 8


def weights_model_section() -> dict:
    return {"preset": "flagship",
            "overrides": {"seq_len": PROMPT_LEN, "max_num_images": N_IMG,
                          "llm": {"num_hidden_layers": WEIGHT_LAYERS}}}


def seeded_tensors(specs, seed: int):
    """``make(key)`` for `write_safetensors`: each tensor of ``specs``
    (``{key: (shape, dtype)}``) drawn on the card, in the order asked,
    from one seeded generator: fan-in scaled normal matrices and kernels,
    1-D norm weights near 1, other 1-D tensors small."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def make(key):
        shape, dt = specs[key]
        x = torch.randn(shape, generator=g, device="cuda")
        if len(shape) >= 2:
            x *= float(np.prod(shape[1:])) ** -0.5
        elif "norm" in key.lower() and key.endswith("weight"):
            x = 1.0 + 0.05 * x
        else:
            x *= 0.05
        return x.to(dt).cpu()

    return make


def write_source(out_dir, specs, seed: int, shards: int = 1,
                 name: str = "model") -> dict:
    """``specs`` as seeded safetensors shards under ``out_dir``: bytes
    and seconds."""
    import torch

    from mm_interleaved_tpu_torch.utils.state_dict_io import write_sharded

    t0 = time.perf_counter()
    files = write_sharded(str(out_dir), [(k, s, d) for k, (s, d)
                                         in specs.items()],
                          seeded_tensors(specs, seed), shards, name)
    torch.cuda.synchronize()
    return dict(files=len(files), bytes=sum(Path(f).stat().st_size
                                            for f in files),
                write_s=time.perf_counter() - t0)


def run_converter(*args) -> dict:
    """``python -m mm_interleaved_tpu_torch.convert_checkpoint`` in a
    process of its own (its peak host RSS its own), on the card; its JSON
    line, and its wall seconds from the start of the process."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "mm_interleaved_tpu_torch.convert_checkpoint",
         *args, "--dtype", "bfloat16", "--device", "cuda"],
        capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise AssertionError(f"convert_checkpoint {args} exited "
                             f"{out.returncode}: {out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["process_s"] = time.perf_counter() - t0
    return res


def check_converted(path, parts) -> dict:
    """Every tensor the maps of ``parts`` (``(source, map)``) fill equals,
    in the file at ``path``, its source tensor transformed on the card
    (`torch.equal`)."""
    import torch

    from mm_interleaved_tpu_torch.utils.checkpoint import read_full_checkpoint
    from mm_interleaved_tpu_torch.utils.name_map import convert_entry

    t0 = time.perf_counter()
    params = read_full_checkpoint(str(path))["params"]
    bad, n = [], 0
    for sd, nmap in parts:
        for name, e in nmap.items():
            got = params[name].to("cuda")
            # (an entry with no source, the TextDecoder's new head, is
            # made on the host)
            want = convert_entry(e, sd, "cuda").to("cuda", got.dtype)
            n += 1
            if not torch.equal(got, want):
                bad.append(name)
    if bad:
        raise AssertionError(f"{len(bad)} converted tensors differ from "
                             f"their sources: {bad[:8]}")
    return dict(checked=n, params=len(params),
                check_s=time.perf_counter() - t0)


def weights_slices(model) -> dict:
    """Phase 5's text slice (``WEIGHT_TOKENS`` greedy tokens) and a
    ``WEIGHT_STEPS``-step CFG denoise of phase 6 on the loaded model: finite
    outputs of the expected shapes, each run's launches the derived
    count."""
    import torch

    from mm_interleaved_tpu_torch.generation.diffusion import generate_images
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)

    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, "cuda")
    gen = TextGenerationConfig(max_new_tokens=WEIGHT_TOKENS, eos_token_ids=(),
                               pad_token_id=cfg.special.pad_token_id)
    tokens, text_ms, text_launches = timed(generate_texts, model, ids, images,
                                           n_img, att, gen)
    want = bench_text_launches(cfg, WEIGHT_TOKENS)
    if text_launches != want:
        raise AssertionError(f"text slice launches {text_launches} != {want}")
    if tuple(tokens.shape) != (B, WEIGHT_TOKENS) or not (
            (tokens >= 0) & (tokens < cfg.llm.vocab_size)).all():
        raise AssertionError(f"text slice tokens {tokens}")

    def image_run():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 7)
        inp = model.generate_image_inputs(ids, images, n_img, att)
        rows = torch.arange(B * cfg.max_num_images, device="cuda")
        rows = rows[(rows % cfg.max_num_images) < N_IMG]
        return generate_images(model, *(x[rows] for x in inp),
                               num_inference_steps=WEIGHT_STEPS,
                               guidance_scale=GUIDANCE, generator=g)

    out, image_ms, image_launches = timed(image_run)
    want = expected_image_launches(cfg, WEIGHT_STEPS, B * N_IMG)
    if image_launches != want:
        raise AssertionError(f"denoise launches {image_launches} != {want}")
    size = cfg.image_decoder.image_size
    if tuple(out.shape) != (B * N_IMG, size, size, 3) or not bool(
            torch.isfinite(out).all()) or float(out.min()) < 0 or float(
            out.max()) > 1:
        raise AssertionError(f"denoise images {tuple(out.shape)}")
    return dict(tokens=tokens[:, :8].tolist(), text_ms=text_ms,
                image_ms=image_ms, image_mean=float(out.mean()),
                launches=add_launches(text_launches, image_launches))


def run_released_mode(root, section, config) -> dict:
    """Phase 15a: a reference-format checkpoint of the cut flagship (the
    name map's keys and shapes and the fixed buffers it skips), seeded bf16
    in ``WEIGHT_SHARDS`` safetensors shards; the converter on the card;
    every port parameter against its source; `load_model`; the text slice
    and the denoise on it."""
    import gc

    import torch

    from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
    from mm_interleaved_tpu_torch.utils import convert_ref
    from mm_interleaved_tpu_torch.utils.checkpoint import load_model
    from mm_interleaved_tpu_torch.utils.config import build_model_config
    from mm_interleaved_tpu_torch.utils.name_map import source_specs
    from mm_interleaved_tpu_torch.utils.state_dict_io import (
        load_torch_state_dict)

    cfg = build_model_config(section)
    with torch.device("meta"):
        skeleton = MMInterleaved(cfg)
    shapes = {n: tuple(p.shape) for n, p in skeleton.named_parameters()}
    nmap = convert_ref.convert_mm_interleaved(cfg, shapes.__contains__)
    if set(nmap) != set(shapes):
        raise AssertionError("the released-model map does not fill the model")
    specs = {k: (s, torch.bfloat16)
             for k, s in source_specs(nmap, shapes).items()}
    # the fixed buffers a released checkpoint holds, which the map skips
    specs["visual_tokenizer.pos_embed"] = ((1, 256, 4096), torch.bfloat16)
    specs["visual_tokenizer.clip_mean"] = ((1, 1, 1, 3), torch.float32)
    specs["visual_tokenizer.clip_std"] = ((1, 1, 1, 3), torch.float32)
    specs["image_decoder.decoder.mmfs_module.mmfs_down_blocks.0.pos_embed"] \
        = ((1, 4096, 1024), torch.bfloat16)
    src = write_source(root / "released", specs, SEED + 11, WEIGHT_SHARDS)
    out = root / "released.pt"
    conv = run_converter("--config", config, "--ref-checkpoint",
                         str(root / "released"), "--out", str(out))
    sd = load_torch_state_dict(str(root / "released"))
    check = check_converted(out, [(sd, nmap)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load_model(cfg, "cuda", str(out))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reset_counts()
    slices = weights_slices(model)
    del model, sd
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root / "released", ignore_errors=True)
    out.unlink()
    return dict(source=src, convert=conv, check=check, load_s=load_s,
                slices=slices, model_params=sum(
                    int(np.prod(s)) for s in shapes.values()))


def run_tower_mode(root, section, config) -> dict:
    """Phase 15b: HF-named LLaMA shards (the cut depth, 32,000 rows and an
    ``lm_head``; an old checkpoint's rotary buffer beside them), a CLIP
    vision directory (ViT-L/14, its post layernorm beside it) and a
    diffusers unet/ + vae/ pair (SD-2.1), seeded bf16, each holding the
    keys of the converter's tower maps; the tower mode on the card; every
    converted tensor against its source, the padded embedding rows against
    the mean embedding, the TextDecoder's heads as built from ``lm_head``.
    The output stays for the warm start."""
    import argparse

    import torch

    from mm_interleaved_tpu_torch import convert_checkpoint as cc
    from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
    from mm_interleaved_tpu_torch.utils.checkpoint import read_full_checkpoint
    from mm_interleaved_tpu_torch.utils.config import build_model_config
    from mm_interleaved_tpu_torch.utils.name_map import source_specs

    cfg = build_model_config(section)
    with torch.device("meta"):
        skeleton = MMInterleaved(cfg)
    shapes = {n: tuple(p.shape) for n, p in skeleton.named_parameters()}
    bf = torch.bfloat16
    orig = cfg.orig_vocab_size
    vit = cfg.visual.encoder.vit.hidden_size

    def specs(nmap, **extra):
        out = {k: (s, bf) for k, s in source_specs(nmap, shapes).items()}
        out.update(extra)
        return out

    sd_maps = cc.sd_maps(cfg, shapes)
    written = [
        write_source(root / "llm", specs(
            cc.llm_map(cfg, lm_head_rows=orig),
            **{"model.layers.0.self_attn.rotary_emb.inv_freq":
               ((cfg.llm.head_dim // 2,), torch.float32)}),
            SEED + 12, WEIGHT_SHARDS),
        write_source(root / "clip", specs(
            cc.clip_map(cfg),
            **{f"vision_model.post_layernorm.{leaf}": ((vit,), bf)
               for leaf in ("weight", "bias")}), SEED + 13),
        *(write_source(root / "sd" / sub, specs(nmap), SEED + 14 + i,
                       name="diffusion_pytorch_model")
          for i, (sub, nmap) in enumerate(sd_maps.items()))]
    out = root / "towers.pt"
    dirs = dict(llm=str(root / "llm"), clip=str(root / "clip"),
                sd=str(root / "sd"))
    conv = run_converter("--config", config, "--llm", dirs["llm"], "--clip",
                         dirs["clip"], "--sd", dirs["sd"], "--seed", str(SEED),
                         "--out", str(out))
    parts = cc.tower_parts(argparse.Namespace(ref_checkpoint=None, **dirs),
                           cfg, shapes)
    check = check_converted(out, [(sd, nmap) for sd, nmap, _ in parts])
    params = read_full_checkpoint(str(out))["params"]
    src = parts[0][0]
    emb = params["mm_decoder.embed_tokens.weight"].to("cuda").double()
    mean = src["model.embed_tokens.weight"].to("cuda").double().mean(0)
    pad_err = float((emb[orig:] - mean).abs().max())
    pad_tol = _ulps(float(mean.abs().max()))  # the one bf16 rounding
    if not pad_err <= pad_tol:
        raise AssertionError(f"padded embedding rows {pad_err} from the "
                             f"mean > {pad_tol}")
    head_w = params["text_decoder.head.weight"].to("cuda")
    head_b = params["text_decoder.head.bias"]
    new_w, new_b = (params[f"text_decoder.head_new.{k}"]
                    for k in ("weight", "bias"))
    heads = dict(
        rows=torch.equal(head_w[:orig], src["lm_head.weight"].to("cuda")),
        new_rows_zero=not bool(head_w[orig:].any()),
        bias=bool((head_b[:orig] == 0).all() and (head_b[orig:] == -100).all()),
        head_new=not bool(new_w.any()) and bool((new_b == 95).all()))
    if not all(heads.values()):
        raise AssertionError(f"TextDecoder heads: {heads}")
    del params, parts, src
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return dict(source=dict(bytes=sum(w["bytes"] for w in written),
                            write_s=sum(w["write_s"] for w in written),
                            files=sum(w["files"] for w in written)),
                convert=conv, check=check, pad_err=pad_err, pad_tol=pad_tol,
                heads=heads)


def run_warm_start(section, ckpt) -> dict:
    """Phase 15c: `train.main` with ``training.load_from`` the tower
    output, one step on the cut flagship (2 rows of 256 tokens): at the
    step's start the update count 0, the masters and the weights the file's,
    the moments zero; the step's launches the derived count (kernels 1, 2,
    3, 5, 5b and 6 among them); its metrics finite."""
    import torch

    from mm_interleaved_tpu_torch.engine.trainer import Trainer
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR
    from mm_interleaved_tpu_torch.utils.checkpoint import read_full_checkpoint
    from mm_interleaved_tpu_torch.utils.config import (build_model_config,
                                                       load_config)

    config = smoke_train_config("smoke_warm_start", section, warmup_steps=0,
                                max_steps=1, load_from=str(ckpt))
    model_cfg = build_model_config(load_config(config)["model"])
    state = read_full_checkpoint(str(ckpt))["params"]
    seen = {}
    step = Trainer.train_step

    def first_step(self, batch, draws=None):
        if not seen:
            opt = self.optimizer
            seen["count"] = opt.count
            seen["masters"] = all(
                torch.equal(x, state[n].to(x.device, torch.float32))
                for n, x in zip(opt.names, opt.masters))
            seen["weights"] = all(
                torch.equal(p.detach(), state[n].to(p.device, p.dtype))
                for n, p in self.model.named_parameters())
            seen["moments_zero"] = not any(bool(m.any()) or bool(v.any())
                                           for m, v in zip(opt.m, opt.v))
            x = batch["image_tensors"]
            seen["images"] = int(x.shape[0] * x.shape[1])
        return step(self, batch, draws)

    out_dir = BUILD_DIR.parent / "smoke_warm_start"
    shutil.rmtree(out_dir, ignore_errors=True)
    unsaved = out_dir / "not_saved"
    save = Trainer.maybe_save

    def no_save(self, data_state=None, force=False):
        # phase 11 writes and checks the flagship's final checkpoint; this
        # one would be 13.7 GB more of the same
        unsaved.parent.mkdir(parents=True, exist_ok=True)
        unsaved.touch()
        return unsaved

    Trainer.train_step, Trainer.maybe_save = first_step, no_save
    reset_counts()
    t0 = time.perf_counter()
    try:
        res = train_entry(config, str(out_dir))
    finally:
        Trainer.train_step, Trainer.maybe_save = step, save
    launches = read_counts()
    run_s = time.perf_counter() - t0
    # the run's checkpoints record the file, so a resume reads its frozen
    # weights again
    recorded = res["trainer"].load_from or {}
    if recorded.get("path") != os.path.abspath(ckpt):
        raise AssertionError(f"warm start recorded {recorded}")
    del res["trainer"], state
    shutil.rmtree(out_dir, ignore_errors=True)
    if not (seen.get("count") == 0 and seen["masters"] and seen["weights"]
            and seen["moments_zero"]):
        raise AssertionError(f"warm start at count 0: {seen}")
    (s, m), = res["logged"]
    if s != 1 or not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"warm-start step {res['logged']}")
    want = expected_train_launches(model_cfg, seen["images"])
    if launches != want:
        raise AssertionError(f"warm-start launches {launches} != {want}")
    if not all(launches[k] > 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a training kernel did not launch: {launches}")
    return dict(seen=seen, metrics=m, launches=launches, run_s=run_s)


def seeded_module(module, seed: int):
    """``module`` (built on the meta device) on the card with seeded
    values: fan-in scaled matrices and kernels, norm weights near 1, every
    other tensor (biases, embeddings, batch-norm statistics) small, the
    running variances in [0.5, 1.5]."""
    import torch

    module = module.to_empty(device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if not t.is_floating_point():
                t.zero_()
                continue
            x = torch.randn(t.shape, generator=g, device="cuda")
            if name.endswith("running_var"):
                x = 0.5 + torch.rand(t.shape, generator=g, device="cuda")
            elif t.ndim >= 2:
                x *= float(np.prod(t.shape[1:])) ** -0.5
            elif "norm" in name or name.endswith("bn.weight"):
                x = 1.0 + 0.05 * x
            else:
                x *= 0.05
            t.copy_(x)
    return module.eval()


def run_clip_towers() -> dict:
    """Phase 15d: the CLIP text tower at ViT-L/14's text width (768 wide,
    12 layers of 12 heads, 77 tokens) and the projected vision tower
    (ViT-L/14, 224 px), seeded, fp32, on the card: ``CLIP_CAPTIONS``
    captions' ids (end-of-text at varying places, one row without), kernel
    5 at the text tower's causal site against its plain version (phase 7's
    tolerances), the text features and the projected features of
    ``CLIP_CANDIDATES`` images a caption against the CPU's plain path
    within 1e-4 of their scale, the rerank's picks the CPU's."""
    import copy

    import torch

    from mm_interleaved_tpu_torch.models.clip_text import (
        CLIPTextConfig, CLIPTextModel, CLIPVisionTower)
    from mm_interleaved_tpu_torch.models.vit import ViTConfig
    from mm_interleaved_tpu_torch.utils.fid import (CLIPViTFeatures,
                                                    make_clip_rerank_fn)

    text_cfg = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                              num_hidden_layers=12, num_attention_heads=12,
                              projection_dim=768)
    with torch.device("meta"):
        text = CLIPTextModel(text_cfg)
        vision = CLIPVisionTower(ViTConfig(), text_cfg.projection_dim)
    text = seeded_module(text, SEED + 21)
    vision = seeded_module(vision, SEED + 22)
    rng = np.random.RandomState(SEED + 23)
    T, eos = text_cfg.max_position_embeddings, text_cfg.eos_token_id
    ids = rng.randint(0, eos - 1, size=(CLIP_CAPTIONS, T))
    ids[:, 0] = eos - 1  # <|startoftext|>
    for i, n in enumerate(rng.randint(3, T, size=CLIP_CAPTIONS - 1)):
        ids[i, n:] = eos  # the caption's end, then the padding
    ids = torch.from_numpy(ids).cuda()
    cases = {}
    with torch.inference_mode():
        with capture(["flash_attention_fwd"], cases, site="clip_text"):
            text(ids)
        (_, feats), text_call_ms, launches = timed(text, ids)
        text_ms = time_ms(lambda: text(ids))
        text_cpu = copy.deepcopy(text).cpu()
        _, feats_cpu = text_cpu(ids.cpu())
    def check_launches(tower, got, flash):
        """The window's launches: ``flash`` of kernel 5, none of the rest."""
        want = {k: (flash if k == "flash_attention_fwd" else 0)
                for k in KERNELS}
        if got != want:
            raise AssertionError(f"CLIP {tower} tower launches {got} != the "
                                 f"derived {want}")

    check_launches("text", launches, text_cfg.num_hidden_layers)
    site, = compare_kernel("flash_attention_fwd",
                           cases["flash_attention_fwd"], sites=["clip_text"])
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 24)
    n_img = CLIP_CAPTIONS * CLIP_CANDIDATES
    images = torch.rand((n_img, 224, 224, 3), generator=g, device="cuda")
    image_fn = CLIPViTFeatures(vision, projected=True)
    reset_counts()
    img, image_ms, vision_launches = timed(image_fn, images.cpu().numpy())
    check_launches("vision", vision_launches, vision.cfg.num_hidden_layers
                   * -(-n_img // image_fn.batch_size))
    img_cpu = CLIPViTFeatures(copy.deepcopy(vision).cpu(), projected=True)(
        images.cpu().numpy())
    errs = {}
    for tag, got, want in (("text", feats.float().cpu(), feats_cpu),
                           ("image", torch.from_numpy(img),
                            torch.from_numpy(img_cpu))):
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        errs[tag] = dict(max_abs_err=err, scale=scale)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"CLIP {tag} features: card vs CPU {err} > "
                                 f"1e-4 x {scale}")
    captions = list(range(CLIP_CAPTIONS))
    picks = make_clip_rerank_fn(lambda _: img, lambda _: feats.float().cpu()
                                .numpy())(images.cpu().numpy(), captions)
    picks_cpu = make_clip_rerank_fn(lambda _: img_cpu,
                                    lambda _: feats_cpu.numpy())(
        images.cpu().numpy(), captions)
    if not np.array_equal(picks, picks_cpu):
        raise AssertionError(f"rerank picks {picks} != the CPU's {picks_cpu}")
    del text_cpu
    return dict(site=site, errors=errs, picks=picks.tolist(),
                text_ms=text_ms, text_call_ms=text_call_ms,
                image_ms=image_ms, images=n_img,
                launches=add_launches(launches, vision_launches))


def run_inception() -> dict:
    """Phase 15e: InceptionV3 at 299 px, seeded, fp32, on the card against
    the CPU within 1e-5 of the features' scale (the same sums in cuDNN's
    and the CPU's orders over 94 convolutions with batch norm; the limit
    lies between fp32's reading and that of the same check with cuDNN's
    TF32 convolutions, which is reported beside it); ms per image over a
    batch of ``INCEPTION_IMAGES``."""
    import copy

    import torch

    from mm_interleaved_tpu_torch.utils.inception_v3 import (
        InceptionV3Features)

    with torch.device("meta"):
        model = InceptionV3Features()
    model = seeded_module(model, SEED + 31)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 32)
    x = torch.rand((INCEPTION_IMAGES, 299, 299, 3), generator=g,
                   device="cuda")
    with torch.inference_mode():
        got = model(x)
        want = copy.deepcopy(model).cpu()(x.cpu())
        ms = time_ms(lambda: model(x))
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            got_tf32 = model(x)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    err = float((got.cpu() - want).abs().max())
    scale = float(want.abs().max())
    if tuple(got.shape) != (INCEPTION_IMAGES, 2048) or not err <= 1e-5 * scale:
        raise AssertionError(f"InceptionV3 card vs CPU {err} (scale "
                             f"{scale}), shape {tuple(got.shape)}")
    return dict(max_abs_err=err, scale=scale,
                tf32_max_abs_err=float((got_tf32.cpu() - want).abs().max()),
                ms_per_image=ms / INCEPTION_IMAGES, batch_ms=ms)


def run_weights_phase() -> dict:
    """Phase 15: weights from files on the card: the released-model mode,
    the tower mode, the warm start, the CLIP towers, InceptionV3.  Raises on
    any failed check."""
    import gc

    import torch
    import yaml

    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    root = BUILD_DIR.parent / "smoke_weights"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    section = weights_model_section()
    config = root / "model.yaml"
    config.write_text(yaml.safe_dump({"model": section}))
    done = {}
    for name, fn, a in (
            ("released", run_released_mode, (root, section, str(config))),
            ("towers", run_tower_mode, (root, section, str(config))),
            ("warm", run_warm_start, (section, root / "towers.pt")),
            ("clip", run_clip_towers, ()),
            ("inception", run_inception, ())):
        t1 = time.perf_counter()
        done[name] = fn(*a)
        log(f"phase 15 {name}: {time.perf_counter() - t1:.1f} s")
    released, towers, warm, clip, inception = done.values()
    shutil.rmtree(root, ignore_errors=True)
    return dict(released=released, towers=towers, warm=warm, clip=clip,
                inception=inception,
                launches=add_launches(released["slices"]["launches"],
                                      warm["launches"], clip["launches"]),
                wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# int8 weight-only decode and the benchmark datasets (phase 16)

QUANT_STEPS = 5
QUANT_BEAM = VQA_BEAM
# the decode rows phase 16c adds to the captured sites (B = 2 greedy, K = 3
# x B = 2 and K = 5 x B = 2 beams are captured): the bench's decode at B = 8
INT8_DECODE_ROWS = (8,)
# name: (M, N, K, bias): the bodies' edges; in bf16 every K % 16 == 0
# edge takes the wgmma body (its plan logged): x rows straddling its tiles
# of 8 / 16 / 32 / 64 / 128 / 256, N off its 128-row tiles, K under one
# 64-wide K tile and off it
INT8_EDGES = {
    "k_not_16_gemv": (3, 96, 200, True),
    "k_not_16_tiled": (40, 70, 200, True),
    "n_ragged_gemv": (2, 5000, 5120, False),
    "n_ragged_tiled": (100, 130, 512, True),
    "m1": (1, 5120, 5120, False),
    "m1_head": (1, 32002, 5120, True),
    "m17": (17, 256, 512, False),
    "m9": (9, 5120, 5120, False),
    "m16": (16, 5120, 5120, True),
    "m17_wide": (17, 5120, 5120, False),
    "m64": (64, 5120, 5120, False),
    "m65": (65, 5120, 5120, True),
    "m257": (257, 5120, 5120, False),
    "n130": (2, 130, 5120, True),
    "n130_m512": (512, 130, 5120, False),
    "n5000_m512": (512, 5000, 5120, True),
    "n2_m512": (512, 2, 5120, True),
    "k16": (2, 5120, 16, True),
    "k48": (10, 5120, 48, False),
    "k48_m512": (512, 5120, 48, True),
    "k5136": (2, 5120, 5136, True),
    "k5136_m512": (512, 5120, 5136, False),
}
RICES_SUPPORT = 16
RICES_QUERIES = 4
RICES_K = 3
BENCH_ROUTES = ("evaluate_caption", "evaluate_t2i", "evaluate_storytelling",
                "evaluate_segm2img")


def int8_launches(cfg, text_forwards: int, prefix_forwards: int = 0) -> int:
    """The int8 kernel's launches: the LLM's seven projections a layer in
    every forward, and the two heads in each forward that makes logits
    (the text forwards; the cache-free prefix forward of
    `generate_image_inputs` stops at the hidden states)."""
    per = 7 * cfg.llm.num_hidden_layers
    return text_forwards * (per + 2) + prefix_forwards * per


def with_int8(counts, n: int) -> dict:
    out = dict(counts)
    out["int8_linear"] = n
    return out


def work_int8(x, q, bias=None):
    """Bytes: x, the codes, the scales, the bias and the output once each;
    operations: 2 M N K at the peak rate of x's dtype."""
    import torch

    M, K = x.shape
    N = q.shape[0]
    nbytes = (_nbytes(x, q) + 4 * N + M * N * x.element_size()
              + (_nbytes(bias) if bias is not None else 0))
    rate = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return 2 * M * N * K, nbytes, rate


def int8_tolerance(x, q, scale, bias, got, want):
    """The elementwise bound of kernel against plain: both dequantize the
    weight with the same rounding, so they differ in the order of two fp32
    sums of the same products (at most K 2^-23 sum_k |x||w| apart) and in
    the roundings to the output dtype after them (the sum, then the bias
    add: at most 2 u (|got| + |want| + |bias|), u = 2^-7 in bf16, 2^-23 in
    fp32, a generous count of the ulps involved)."""
    import torch

    from mm_interleaved_tpu_torch.ops.quant import dequantize_int8

    K = x.shape[1]
    w = dequantize_int8(q, scale, x.dtype).float().abs()
    sums = x.float().abs() @ w.t()
    u = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -23
    mag = got.float().abs() + want.float().abs()
    if bias is not None:
        mag = mag + bias.float().abs()
    return K * 2.0 ** -23 * sums + 2 * u * mag


def int8_plain_exact(x, q, scale, bias):
    """The plain version with cuBLAS's reductions in fp32 (no split-K in
    bf16), as the bound assumes."""
    import torch

    from mm_interleaved_tpu_torch.ops.quant import int8_linear_plain

    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return int8_linear_plain(x, q, scale, bias)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag


def int8_served(rec, tag, x, q, scale, bias) -> None:
    """Record the body (and the wgmma body's plan: x rows a tile and K
    splits) the wrapper picks for this call."""
    from mm_interleaved_tpu_torch.ops.quant import (
        _sms, int8_linear_body, int8_linear_plan)

    M, K = x.shape
    N = q.shape[0]
    body = int8_linear_body(M, N, K, x.dtype)
    rec[f"body_{tag}"] = body
    if body == "wgmma":
        plan = int8_linear_plan(M, N, K, _sms(x.device))
        rec[f"plan_{tag}"] = dict(bn=plan["bn"], split=plan["split"])


def check_int8(x, q, scale, bias, rec, tag, fails) -> None:
    """One call against the plain version within `int8_tolerance`, and two
    runs bit-identical."""
    import torch

    from mm_interleaved_tpu_torch.ops.quant import int8_linear_cuda

    got = int8_linear_cuda(x, q, scale, bias)
    again = int8_linear_cuda(x, q, scale, bias)
    want = int8_plain_exact(x, q, scale, bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = int8_tolerance(x, q, scale, bias, got, want)
    rec[f"max_abs_err_{tag}"] = float(err.max())
    rec[f"worst_err_over_tol_{tag}"] = float((err / tol).max())
    rec[f"bit_identical_{tag}"] = torch.equal(got, again)
    if not bool((err <= tol).all()):
        fails.append(f"{rec['site']} {tag}: error {float(err.max())} over "
                     f"the bound (worst ratio "
                     f"{rec[f'worst_err_over_tol_{tag}']})")
    if not rec[f"bit_identical_{tag}"]:
        fails.append(f"{rec['site']} {tag}: two runs differ")


def compare_int8(sites) -> list:
    """Phase 16c: the int8 kernel against its plain version at each site
    (``name -> (x, q, scale, bias)``, bf16 as captured and in fp32), both
    timed (CUDA events, median of 25), beside the bound of the call and
    `F.linear` on the dequantized weight in the same dtype (cuBLAS over
    the same product's unquantized weight: the library's time); in bf16
    the kernel and `F.linear` also as device time under `torch.profiler`
    and as the mean of 25 calls enqueued back to back."""
    import torch
    import torch.nn.functional as F

    from mm_interleaved_tpu_torch.ops.quant import (
        dequantize_int8, int8_linear_cuda)

    recs, fails = [], []
    for site, (x, q, scale, bias) in sites.items():
        rec = dict(site=site, M=x.shape[0], N=q.shape[0], K=q.shape[1],
                   bias=bias is not None)
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = (x.to(dt), q, scale, None if bias is None else bias.to(dt))
            int8_served(rec, tag, *a)
            with torch.inference_mode():
                check_int8(*a, rec, tag, fails)
                rec[f"ms_{tag}"] = time_ms(lambda: int8_linear_cuda(*a))
                rec[f"plain_ms_{tag}"] = time_ms(lambda: int8_plain_exact(*a))
                w = dequantize_int8(q, scale, dt)
                rec[f"library_ms_{tag}"] = time_ms(
                    lambda: F.linear(a[0], w, a[3]))
                del w
                flops, nbytes, rate = work_int8(a[0], q, a[3])
                ops_ms, bytes_ms = _bound(flops, nbytes, rate)
                if tag == "bf16":
                    rec.update(ops_ms=ops_ms, bytes_ms=bytes_ms,
                               bound_ms=max(ops_ms, bytes_ms),
                               bound_by=("operations" if ops_ms > bytes_ms
                                         else "bytes"),
                               flops=flops, bytes=nbytes,
                               library_ms=rec["library_ms_bf16"])
                    # the device's own time (the events above carry the
                    # host's cost of each call at the small sites)
                    w = dequantize_int8(q, scale, dt)
                    for key, fn in (
                            ("", lambda: int8_linear_cuda(*a)),
                            ("library_", lambda: F.linear(a[0], w, a[3]))):
                        rec[f"{key}device_ms"] = device_ms(fn)
                        rec[f"{key}queued_ms"] = queued_ms(fn)
                    del w
                else:
                    rec["bound_ms_fp32"] = max(ops_ms, bytes_ms)
        recs.append(rec)
        log(f"kernel vs plain, int8_linear {site}: {json.dumps(rec)}")
    if fails:
        raise AssertionError("int8_linear: " + "; ".join(fails))
    return recs


def check_int8_edges() -> list:
    """`INT8_EDGES` in bf16 and fp32 (seeded): the body `int8_linear_body`
    gives (and its plan), within `int8_tolerance` of the plain version,
    two runs bit-identical; a misaligned x refused before any launch where
    K % 16 == 0."""
    import torch

    from mm_interleaved_tpu_torch.ops.quant import (
        int8_linear_cuda, int8_linear_vec, quantize_int8)

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 31)
    recs, fails = [], []
    for name, (M, N, K, has_bias) in INT8_EDGES.items():
        q, scale = quantize_int8(torch.randn(N, K, generator=g,
                                             device="cuda"))
        x = torch.randn(M, K, generator=g, device="cuda")
        bias = torch.randn(N, generator=g, device="cuda") if has_bias \
            else None
        rec = dict(site=name, M=M, N=N, K=K, bias=has_bias)
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            a = (x.to(dt), q, scale, None if bias is None else bias.to(dt))
            int8_served(rec, tag, *a)
            with torch.inference_mode():
                check_int8(*a, rec, tag, fails)
                if int8_linear_vec(K):
                    _refuses_misaligned(f"int8 {name} {tag}",
                                        int8_linear_cuda, a, 0, rec, fails)
        recs.append(rec)
    log(f"int8_linear edge cases: {json.dumps(recs)}")
    if fails:
        raise AssertionError("int8_linear edges: " + "; ".join(fails))
    return recs


@contextlib.contextmanager
def int8_capture(sites, tag: str, max_rows=None):
    """Keep the first inputs of each (M, N, K) call of the int8 kernel's
    wrapper (of at most ``max_rows`` rows) as the site
    ``<tag>_M<M>_N<N>_K<K>`` (the weights by reference: they are the
    model's)."""
    from mm_interleaved_tpu_torch.ops.quant import int8_linear_cuda

    # the counted wrapper stays in place (its launches still count); its
    # launch function is wrapped
    launch = int8_linear_cuda._launch

    def wrapped(x, q, scale, bias=None):
        key = f"{tag}_M{x.shape[0]}_N{q.shape[0]}_K{q.shape[1]}"
        if key not in sites and (max_rows is None
                                 or x.shape[0] <= max_rows):
            sites[key] = (x.clone(), q, scale, bias)
        return launch(x, q, scale, bias)

    int8_linear_cuda._launch = wrapped
    try:
        yield sites
    finally:
        int8_linear_cuda._launch = launch


def run_quant_tiny() -> dict:
    """Phase 16a: the tiny preset, fp32, quantized on the CPU and copied
    to the card (the same int8 weights): the logits along the CPU's greedy
    tokens within 1e-4 of their scale, the card's greedy tokens the CPU's,
    the int8 kernel's launches the derived count."""
    import torch

    from mm_interleaved_tpu_torch.configs import tiny_config
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
    from mm_interleaved_tpu_torch.ops.quant import quantize_llm_weights

    cfg = tiny_config(with_image_decoder=False)
    s = cfg.special
    cpu = build_model(cfg, "cpu", torch.float32, seed=SEED)
    perturb_zero_inits(cpu, SEED + 1)
    names = quantize_llm_weights(cpu)
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(SEED + 3)
    row = [s.bos_token_id, 5, s.soi_token_id] + [s.image_token_id] * \
        cfg.num_img_token + [7, 8, s.soi_token_id] + \
        [s.image_token_id] * cfg.num_img_token + [9]
    ids = torch.tensor([row, [s.pad_token_id] + row[:-1]])
    att = (ids != s.pad_token_id).int()
    imgs = torch.from_numpy(
        rng.rand(2, cfg.max_num_images, 56, 56, 3).astype(np.float32))
    n_img = torch.tensor([2, 2])
    T = 8
    gen = TextGenerationConfig(max_new_tokens=T, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    tok_cpu = generate_texts(cpu, ids, imgs, n_img, att, gen)
    want = teacher_forced_logits(cpu, ids, imgs, n_img, att, tok_cpu)
    dev = [t.cuda() for t in (ids, imgs, n_img, att, tok_cpu)]
    got, _, launches = timed(teacher_forced_logits, gpu, *dev)
    got = got.cpu()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= 1e-4 * max(scale, 1.0):
        raise AssertionError(f"tiny int8 fp32 logits card vs CPU: {err} "
                             f"(scale {scale})")
    if launches["int8_linear"] != int8_launches(cfg, T):
        raise AssertionError(f"tiny int8 launches {launches['int8_linear']} "
                             f"!= {int8_launches(cfg, T)}")
    tok_gpu = generate_texts(gpu, *dev[:4], gen).cpu()
    top2 = want.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    if not torch.equal(tok_gpu, tok_cpu):
        raise AssertionError(f"tiny int8 greedy tokens differ: {tok_gpu} vs "
                             f"{tok_cpu} (top-2 margin {margin})")
    return dict(quantized=len(names), logits_max_abs_err=err,
                logits_scale=scale, top2_margin=margin,
                tokens=tok_cpu.tolist(), launches=launches["int8_linear"])


def llm_proj_bytes(model) -> int:
    """The bytes of the LLM's projection layers as they stand (weights,
    scales, biases)."""
    from mm_interleaved_tpu_torch.ops.quant import is_quant_name

    return sum(t.numel() * t.element_size()
               for n, m in model.named_modules() if is_quant_name(n)
               for t in (*m.parameters(), *m.buffers()))


def run_quant_flagship(greedy_tokens, bf16_peak_gb: float,
                       bf16_decode_ms: float, sites) -> dict:
    """Phase 16b: the flagship of phase 4 (seeded bf16, full width and
    depth, its image decoder) quantized in place, the peak counter reset
    after, then phase 5's text slice (32 greedy tokens, two runs
    identical), a K = 3 beam (two runs identical) and a 5-step CFG denoise
    of phase 6 (the quantized prefix forward): every kernel's launches the
    count derived from the config, the int8 kernel's among them; the
    peak beside phase 5's, at least 11 GB lower.  The int8 kernel's
    inputs are kept at each distinct call for 16c."""
    import gc

    import torch

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.generation.diffusion import generate_images
    from mm_interleaved_tpu_torch.generation.text import (
        TextGenerationConfig, generate_texts)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
    from mm_interleaved_tpu_torch.ops.quant import quantize_llm_weights

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(flagship_config(max_num_images=N_IMG), "cuda",
                        torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    cfg = model.cfg
    bf16_bytes = llm_proj_bytes(model)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    names = quantize_llm_weights(model)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    int8_bytes = llm_proj_bytes(model)
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    ids, images, n_img, att = prompt_inputs(cfg, "cuda")
    s = cfg.special
    gen = TextGenerationConfig(max_new_tokens=NEW_TOKENS, eos_token_ids=(),
                               pad_token_id=s.pad_token_id)
    with int8_capture(sites, "text"):
        generate_texts(model, ids, images, n_img, att,
                       dataclasses.replace(gen, max_new_tokens=2))
    _, first_ms, _ = timed(generate_texts, model, ids, images, n_img, att,
                           dataclasses.replace(gen, max_new_tokens=1))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tokens, gen_ms, text_launches = timed(generate_texts, model, ids, images,
                                          n_img, att, gen)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    again = generate_texts(model, ids, images, n_img, att, gen)
    want = with_int8(bench_text_launches(cfg, NEW_TOKENS),
                     int8_launches(cfg, NEW_TOKENS))
    if text_launches != want:
        raise AssertionError(f"int8 text slice launches {text_launches} != "
                             f"{want}")
    if tuple(tokens.shape) != (B, NEW_TOKENS) or not (
            (tokens >= 0) & (tokens < cfg.llm.vocab_size)).all():
        raise AssertionError(f"int8 text slice tokens {tokens}")
    if not torch.equal(tokens, again):
        raise AssertionError("two int8 greedy runs differ")
    if not peak_gb <= bf16_peak_gb - 11.0:
        raise AssertionError(f"int8 text slice peak {peak_gb:.2f} GB is not "
                             f"11 GB below bf16's {bf16_peak_gb:.2f} GB")

    beam = TextGenerationConfig(
        eos_token_ids=(s.eos_token_id, s.soi_token_id),
        pad_token_id=s.pad_token_id, **QUANT_BEAM)
    with int8_capture(sites, "beam", max_rows=16):
        btok, beam_ms, beam_launches = timed(generate_texts, model, ids,
                                             images, n_img, att, beam)
    bagain = generate_texts(model, ids, images, n_img, att, beam)
    T = beam.max_new_tokens
    want = with_int8(bench_text_launches(cfg, T), int8_launches(cfg, T))
    if beam_launches != want:
        raise AssertionError(f"int8 beam launches {beam_launches} != {want}")
    if not torch.equal(btok, bagain):
        raise AssertionError("two int8 beam runs differ")

    def image_run():
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 7)
        inp = model.generate_image_inputs(ids, images, n_img, att)
        return generate_images(model, *inp, num_inference_steps=QUANT_STEPS,
                               guidance_scale=GUIDANCE, generator=g)

    with int8_capture(sites, "prefix"):
        out, image_ms, image_launches = timed(image_run)
    want = with_int8(expected_image_launches(cfg, QUANT_STEPS, B * N_IMG),
                     int8_launches(cfg, 0, 1))
    if image_launches != want:
        raise AssertionError(f"int8 denoise launches {image_launches} != "
                             f"{want}")
    size = cfg.image_decoder.image_size
    if tuple(out.shape) != (B * N_IMG, size, size, 3) or not bool(
            torch.isfinite(out).all()) or float(out.min()) < 0 or float(
            out.max()) > 1:
        raise AssertionError(f"int8 denoise images {tuple(out.shape)}")
    # the decode rows of the bench (B = 8) and of the caption beam (K = 5
    # x B = 2) on each distinct weight
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 32)
    for key, (x, q, scale, bias) in list(sites.items()):
        if not key.startswith("text_M2_"):
            continue
        for M in INT8_DECODE_ROWS:
            sites[key.replace("text_M2_", f"decode_M{M}_")] = (
                torch.randn(M, x.shape[1], generator=g, device="cuda",
                            dtype=x.dtype), q, scale, bias)
    decode_ms = (gen_ms - first_ms) / (NEW_TOKENS - 1)
    res = dict(
        build_s=t1 - t0, quantize_s=quant_s, quantized=len(names),
        llm_bf16_gb=bf16_bytes / 1e9, llm_int8_gb=int8_bytes / 1e9,
        held_gb=held_gb, peak_gb=peak_gb, bf16_peak_gb=bf16_peak_gb,
        first_ms=first_ms, decode_ms=decode_ms,
        bf16_decode_ms=bf16_decode_ms,
        decode_bound_ms=int8_bytes / PEAK_BYTES * 1e3,
        tokens=tokens[:, :8].tolist(),
        tokens_equal_bf16=float((tokens == greedy_tokens).float().mean()),
        beam_ms=beam_ms, beam_tokens=btok[:, :8].tolist(),
        image_ms=image_ms, image_mean=float(out.mean()),
        launches=add_launches(text_launches, beam_launches, image_launches))
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def bench_route_launches(cfg) -> dict:
    """Each benchmark route's launches on one batch of 2 rows: the caption
    beams (K = 5, 20 tokens); text to image (one candidate) and
    storytelling (one target round) with the CLIP features of their
    generated and ground-truth images; segmentation to image (no
    segmenter: no features)."""
    image = expected_image_launches(cfg, SERVE_STEPS, B)
    clip = clip_feature_launches(cfg.visual.encoder.vit, 2)
    return {
        "evaluate_caption": bench_text_launches(
            cfg, CAPTION_BEAM["max_new_tokens"]),
        "evaluate_t2i": add_launches(image, clip),
        "evaluate_storytelling": add_launches(image, clip),
        "evaluate_segm2img": image,
    }


def run_bench_eval(sites) -> dict:
    """Phase 16d: `evaluate.main` at the flagship (seeded bf16) on the nine
    stanzas of `write_bench_assets` (the eight `datasets_bench` types, VIST
    twice), one batch of 2 each, `SERVE_STEPS` steps, CLIP-FID on: one
    finite row a
    route, each route's launches the derived count, its samples/s; the
    ade20k row without mIoU (the entry passes no segmenter, as JAX's);
    then `Evaluator.evaluate_segm2img` on the ade20k batches with the
    nearest-palette segmenter (a finite mIoU); then the nocaps route again
    with ``evaluation.quantize: int8`` (its decode rows kept for 16c)."""
    import gc

    import torch
    import yaml

    from mm_interleaved_tpu_torch import evaluate
    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.data.datasets import iterate_dataset
    from mm_interleaved_tpu_torch.data.datasets_extra import (
        ade20k_palette, rgb_to_segm)
    from mm_interleaved_tpu_torch.data.synthetic_eval import (
        write_bench_assets)
    from mm_interleaved_tpu_torch.data.tokenizer import load_tokenizer
    from mm_interleaved_tpu_torch.engine.evaluator import (EvalConfig,
                                                           Evaluator)
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
    from mm_interleaved_tpu_torch.ops.cuda_build import BUILD_DIR

    t_phase = time.perf_counter()
    root = BUILD_DIR.parent / "smoke_bench_eval"
    shutil.rmtree(root, ignore_errors=True)
    val = write_bench_assets(str(root / "data"), n=B)
    model = build_model(flagship_config(), "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    cfg = model.cfg

    def run(stanzas, out, **extra):
        config = dict(output_dir=str(root / out),
                      model={"preset": "flagship"},
                      data=dict(tokenizer_path=None, val=stanzas),
                      evaluation=dict(batch_size=B, max_batches=1,
                                      clip_fid=True,
                                      num_inference_steps=SERVE_STEPS,
                                      **extra))
        path = root / f"{out}.yaml"
        path.write_text(yaml.safe_dump(config))
        calls = []
        with recording(Evaluator, BENCH_ROUTES, calls):
            results = evaluate.main(["--config", str(path), "--device",
                                     "cuda"], model=model)
        rows = [json.loads(x) for x in
                (root / out / "eval_metrics.jsonl").read_text().splitlines()]
        return results, rows, calls

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results, rows, calls = run(val, "out")
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    names = [s["dataset_name"] for s in val]
    if [r["dataset"] for r in rows] != names or list(results) != names:
        raise AssertionError(f"bench eval rows {[r['dataset'] for r in rows]}")
    want = bench_route_launches(cfg)
    routes = {}
    for (route, ms, launches), row in zip(calls, rows):
        nums = [v for v in row.values() if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if not all(np.isfinite(nums)):
            raise AssertionError(f"non-finite bench eval row {row}")
        if launches != want[route]:
            raise AssertionError(f"{row['dataset']} ({route}) launched "
                                 f"{launches} != {want[route]}")
        n = row.get("num_samples", row.get("num_generated"))
        if n != B:
            raise AssertionError(f"bench eval row without its samples {row}")
        routes[row["dataset"]] = dict(
            route=route, ms=ms, samples=n, samples_per_s=n / (ms / 1e3),
            row={k: v for k, v in row.items()
                 if k not in ("dataset", "time", "image_dir")})
    if "miou" in rows[-1] or rows[-1]["dataset"] != "synthetic_ade20k":
        raise AssertionError(f"ade20k row {rows[-1]}")
    launches = add_launches(*(c[2] for c in calls))

    # segmentation to image with a segmenter: the generated image's nearest
    # palette colours (1-indexed classes)
    ade = val[-1]
    tok = load_tokenizer(None, vocab_size=cfg.llm.vocab_size,
                         special=cfg.special)
    ds, coll, mode = evaluate.build_eval_dataset(ade, cfg, tok)
    from PIL import Image

    gt = {i: np.asarray(Image.open(ds.gt_id_to_path(i)))
          for i in range(len(ds))}
    pal = ade20k_palette()
    ev = Evaluator(model, tok, EvalConfig(
        batch_size=B, num_inference_steps=SERVE_STEPS, max_batches=1,
        output_dir=str(root / "segm")))
    segm, segm_ms, segm_launches = timed(
        ev.evaluate_segm2img, iterate_dataset(ds, B, coll), gt,
        segment_fn=lambda im: rgb_to_segm(im, pal) + 1)
    if segm_launches != want["evaluate_segm2img"] or not np.isfinite(
            segm.get("miou", np.nan)) or segm["num_generated"] != B:
        raise AssertionError(f"segm2img with a segmenter: {segm}, launches "
                             f"{segm_launches}")

    # the nocaps route with the LLM quantized by the entry's runtime
    with int8_capture(sites, "caption", max_rows=16):
        qresults, qrows, qcalls = run(val[:1], "out_int8", quantize="int8")
    (route, qms, qlaunches), = qcalls
    want_q = with_int8(want["evaluate_caption"], int8_launches(
        cfg, CAPTION_BEAM["max_new_tokens"]))
    if qlaunches != want_q or qrows[0]["num_samples"] != B:
        raise AssertionError(f"int8 caption route {qrows[0]}, launches "
                             f"{qlaunches} != {want_q}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(routes=routes, launches=add_launches(launches, segm_launches,
                                                     qlaunches),
                peak_gb=peak_gb, wall_s=wall_s,
                segm=dict(row=segm, ms=segm_ms),
                int8_caption=dict(ms=qms, row=qrows[0],
                                  samples_per_s=B / (qms / 1e3),
                                  bf16_ms=routes["synthetic_nocaps"]["ms"]),
                phase_s=time.perf_counter() - t_phase)


def run_rices() -> dict:
    """Phase 16e: RICES over a seeded support set of ``RICES_SUPPORT``
    images at 224 px with `CLIPViTFeatures` of a seeded CLIP ViT-L/14
    (fp32; the unprojected cls feature, as the evaluation entry's) on the
    card, ``RICES_QUERIES`` queries, top ``RICES_K``: the
    support and query features within 1e-4 of their scale of the CPU's
    (phase 15's tolerance), the same picks; the kernel 5 launches of the
    window the derived count."""
    import copy

    import torch

    from mm_interleaved_tpu_torch.data.rices import RICES
    from mm_interleaved_tpu_torch.models.clip_text import CLIPVisionTower
    from mm_interleaved_tpu_torch.models.vit import ViTConfig
    from mm_interleaved_tpu_torch.utils.fid import CLIPViTFeatures

    vcfg = ViTConfig()
    with torch.device("meta"):
        vit = CLIPVisionTower(vcfg, 768)
    vit = seeded_module(vit, SEED + 41)
    rng = np.random.RandomState(SEED + 42)
    support = [(rng.rand(224, 224, 3).astype(np.float32), f"caption {i}", i)
               for i in range(RICES_SUPPORT)]
    queries = rng.rand(RICES_QUERIES, 224, 224, 3).astype(np.float32)
    reset_counts()
    (rices, picks), ms, launches = timed(
        lambda: (lambda r: (r, r.find(queries, RICES_K)))(
            RICES(support, CLIPViTFeatures(vit))))
    want = clip_feature_launches(vcfg, 2)
    if launches != want:
        raise AssertionError(f"RICES launches {launches} != {want}")
    cpu = RICES(support, CLIPViTFeatures(copy.deepcopy(vit).cpu()))
    picks_cpu = cpu.find(queries, RICES_K)
    scale = float(np.abs(cpu.features).max())
    err = float(np.abs(rices.features - cpu.features).max())
    if not err <= 1e-4 * scale:
        raise AssertionError(f"RICES features card vs CPU {err} > 1e-4 x "
                             f"{scale}")
    if picks != picks_cpu:
        raise AssertionError(f"RICES picks {picks} != the CPU's {picks_cpu}")
    return dict(picks=picks, max_abs_err=err, scale=scale, ms=ms,
                launches=launches)



def run_quant_phase(greedy_tokens, bf16_peak_gb: float,
                    bf16_decode_ms: float) -> dict:
    """Phase 16: (a) the tiny preset quantized, card against CPU; (b) the
    quantized flagship's text slice, beam and denoise; (d) the benchmark
    datasets through the evaluation entry, segmentation to image with a
    segmenter, a caption route quantized; (c) the int8 kernel against its
    plain version at every captured site and at the edges; (e) RICES."""
    t0 = time.perf_counter()
    tiny = run_quant_tiny()
    sites = {}
    flag = run_quant_flagship(greedy_tokens, bf16_peak_gb, bf16_decode_ms,
                              sites)
    bench_eval = run_bench_eval(sites)
    recs = compare_int8(sites)
    edges = check_int8_edges()
    rices = run_rices()
    return dict(tiny=tiny, flagship=flag, bench_eval=bench_eval,
                sites=recs, edges=edges, rices=rices,
                wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------
# the sharded runtime (phase 17)

# phase 17b's model: the flagship's widths with TP_LAYERS LLM layers (2 of
# them MMFS: cross_attention_frequency 4) and its image decoder
TP_LAYERS = 8
TP_TOKENS = 4
# phases 17a's and 17b's denoise of the first two images of row 0
SHARD_STEPS = 5
TP_TIMEOUT = 600
# the two-rank run's logits and images against the same weights' fp32
# one-process ones: the row-parallel sums round each rank's bf16 partial
# before the sum, so its error is held to that of the one-process bf16 run
# (max and mean), within this factor
TP_ERR_FACTOR = 1.5
# 17b's captured sites held against their plain versions at the local
# shapes (rank 0)
TP_SITES = {
    "ms_deform_attn_fwd": ["injector", "extractor", "mmfs_prefill",
                           "mmfs_decode"],
    "ms_deform_attn_mi_fwd": ["unet_32px"],
    "flash_attention_fwd": ["llm_prefix", "vit", "qformer_self",
                            "decoder_perceiver", "unet_attn1_32px",
                            "unet_attn1_16px"],
    "geglu_fwd": ["C320", "C640"],
}
# 18b's: the LLM's and the towers' training sites
TRAIN_TP_SITES = {
    "ms_deform_attn_fwd": ["mmfs_prefill", "injector"],
    "flash_attention_fwd": ["llm_prefix", "vit"],
    "ms_deform_attn_bwd_value": ["mmfs_llm", "unet_64px"],
    "ms_deform_attn_bwd_loc_weight": ["mmfs_llm", "extractor"],
    "flash_attention_bwd": ["llm_prefix", "qformer_self", "unet_attn1_32px"],
}


def tp_local_heads(cfg, name: str, site: str, parts: int = 2) -> int:
    """The heads (GEGLU: the hidden width) of ``name``'s call at ``site``
    on a rank at ``tensor = parts``, derived from the config: a pair's
    heads over ``parts`` where ``parts`` divides them, else all."""
    def local(n):
        return n // parts if n % parts == 0 else n

    if name == "geglu_fwd":
        return local(4 * int(site[1:]))
    if name.startswith("ms_deform_attn") and site in ("injector",
                                                      "extractor"):
        return local(cfg.visual.encoder.vit.num_attention_heads)
    if name.startswith("ms_deform_attn") and site.startswith("mmfs"):
        return local(cfg.llm.mmfs_heads)
    if name.startswith("ms_deform_attn"):
        return local(cfg.image_decoder.unet.mmfs.n_heads)
    u = cfg.image_decoder.unet
    heads = {"llm_prefix": cfg.llm.num_attention_heads,
             "vit": cfg.visual.encoder.vit.num_attention_heads,
             "qformer_self": cfg.visual.perceiver.num_attention_heads,
             "qformer_cross": cfg.visual.perceiver.num_attention_heads,
             "decoder_perceiver":
                 cfg.image_decoder.perceiver.num_attention_heads}
    if site in heads:
        return local(heads[site])
    # unet_attn{1,2}_{px}px: the block width at that resolution
    px = int(site.rsplit("_", 1)[1][:-2])
    level = int(round(np.log2(u.sample_size // px)))
    return local(u.block_out_channels[level] // u.attention_head_dim)


def site_heads(name: str, args) -> int:
    """The heads (GEGLU: the hidden width) of a captured call."""
    if name == "geglu_fwd":
        return args[3].shape[1]
    if name in ("ms_deform_attn_fwd", "ms_deform_attn_bwd_value",
                "ms_deform_attn_bwd_loc_weight"):
        return args[2].shape[2]
    if name == "ms_deform_attn_mi_fwd":
        return args[0].shape[3]
    return args[0].shape[-2]


def check_local_heads(tag: str, cfg, cases, sites) -> None:
    """Every captured site of ``sites`` ran at its rank's heads."""
    for name, want in sites.items():
        for site in want:
            if site not in cases.get(name, {}):
                raise AssertionError(f"{tag} {name}: no call at {site}")
            got = site_heads(name, cases[name][site][0])
            if got != tp_local_heads(cfg, name, site):
                raise AssertionError(
                    f"{tag} {name} {site}: {got} heads (or hidden columns), "
                    f"not {tp_local_heads(cfg, name, site)}")


def free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def param_bytes(model, pattern: str) -> int:
    import re

    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters() if re.search(pattern, n))


def cut_bytes(model, cuts) -> int:
    """The bytes of ``model``'s weights of ``cuts`` (`parallel.tensor.
    tensor_cuts` of the whole model at tensor = 2: the LLM's, the towers'
    and the vocabulary's pairs, by head, column or row): each rank holds
    half of them."""
    return sum(p.numel() * p.element_size()
               for n, p in model.named_parameters() if n in cuts)


def plan_bytes() -> dict:
    """A rank's weight bytes of the flagship (bf16, on ``meta``: shapes
    only) under the plan at tensor = 2 and 4 (`rank_bytes`), beside the
    plan that cut the LLM's layers alone (the towers and the vocabulary
    whole)."""
    import torch

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import MMInterleaved
    from mm_interleaved_tpu_torch.parallel.partition import rank_bytes

    with torch.device("meta"):
        model = MMInterleaved(flagship_config()).to(torch.bfloat16)
    llm = r"^mm_decoder\.layers\."
    out = dict(whole=rank_bytes(model, {}))
    for t in (2, 4):
        out[f"tensor_{t}"] = rank_bytes(model, {"tensor": t})
        out[f"tensor_{t}_llm_layers_alone"] = (
            rank_bytes(model, {"tensor": t}, llm)
            + rank_bytes(model, {}, r"^(?!mm_decoder\.layers\.)"))
    return out


def run_sharded_one() -> dict:
    """Phase 17a: the sharded runtime at world size 1 on the flagship (full
    width and depth, bf16, phase 4's seed and config): a nccl group of one
    rank, ``make_mesh(1, 1, 1)``, `ShardedGenerator`; greedy tokens
    (phase 5's settings) and the denoise of row 0's two images
    (``SHARD_STEPS`` steps, one seeded generator) against
    `LocalGenerator`'s on the same model, bit for bit, every launch window
    (counts at 0 before, read after) its count derived from the config."""
    import torch
    import torch.distributed as dist

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
    from mm_interleaved_tpu_torch.parallel.inference import (
        LocalGenerator, ShardedGenerator)
    from mm_interleaved_tpu_torch.parallel.partition import make_mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        cfg = flagship_config(max_num_images=N_IMG)
        model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED)
        perturb_zero_inits(model, SEED + 1)
        ids, images, n_img, att = prompt_inputs(cfg, "cuda")
        gen = TextGenerationConfig(max_new_tokens=NEW_TOKENS,
                                   eos_token_ids=(),
                                   pad_token_id=cfg.special.pad_token_id)

        def first_images(rt):
            inp = rt.generate_image_inputs(ids, images, n_img, att)
            g = torch.Generator(device="cuda")
            g.manual_seed(SEED + 7)
            return rt.denoise(*(x[:2] for x in inp), g,
                              num_inference_steps=SHARD_STEPS,
                              guidance_scale=GUIDANCE)

        out = {}
        for name, rt in (("local", lambda: LocalGenerator(model)),
                         ("sharded", lambda: ShardedGenerator(
                             model, make_mesh(1, 1, 1, "cuda")))):
            rt = rt()
            reset_counts()
            tokens, text_ms, _ = timed(rt.generate_texts, ids, images, n_img,
                                       att, gen)
            text = read_counts()
            reset_counts()
            imgs, image_ms, _ = timed(first_images, rt)
            image = read_counts()
            out[name] = dict(tokens=tokens, images=imgs, text=text,
                             image=image, text_ms=text_ms,
                             image_ms=image_ms)
        want = dict(text=bench_text_launches(cfg, NEW_TOKENS),
                    image=expected_image_launches(cfg, SHARD_STEPS, 2))
        for name in out:
            for part in ("text", "image"):
                if out[name][part] != want[part]:
                    raise AssertionError(
                        f"17a {name} {part} launches {out[name][part]} != "
                        f"{want[part]}")
        loc, sh = out["local"], out["sharded"]
        if not torch.equal(sh["tokens"], loc["tokens"]):
            raise AssertionError("17a: the sharded greedy tokens differ from "
                                 "LocalGenerator's")
        if not torch.equal(sh["images"], loc["images"]):
            raise AssertionError("17a: the sharded images differ from "
                                 "LocalGenerator's")
        if not torch.isfinite(sh["images"]).all():
            raise AssertionError("17a: non-finite images")
        del model
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return dict(tokens=sh["tokens"], launches=add_launches(sh["text"],
                                                           sh["image"]),
                text_ms=(loc["text_ms"], sh["text_ms"]),
                image_ms=(loc["image_ms"], sh["image_ms"]),
                wall_s=time.perf_counter() - t0)


def tp_config():
    import dataclasses as dc

    from mm_interleaved_tpu_torch.configs import flagship_config

    cfg = flagship_config(max_num_images=N_IMG)
    return dc.replace(cfg, llm=dc.replace(cfg.llm,
                                          num_hidden_layers=TP_LAYERS))


def tp_model():
    import torch

    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    model = build_model(tp_config(), "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    return model


def tp_forward(rt, cases=None, denoise=True) -> dict:
    """Through the runtime ``rt``: ``TP_TOKENS`` greedy tokens on the phase
    5 prompt (counts at 0 before, read after); with its model, the
    teacher-forced logits along them and the cache-free causal forward's
    logits of the whole prompt (kernel 5 at the LLM's heads), kernels 1
    and 5 captured into ``cases`` when given; with ``denoise``, the
    ``SHARD_STEPS``-step denoise of row 0's two images (phase 17a's, one
    seeded generator) in a launch window of its own, kernels 1, 4, 5 and
    7 captured."""
    import torch

    from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig

    model = rt.model
    cfg = model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, "cuda")
    gen = TextGenerationConfig(max_new_tokens=TP_TOKENS, eos_token_ids=(),
                               pad_token_id=cfg.special.pad_token_id)
    reset_counts()
    tokens = rt.generate_texts(ids, images, n_img, att, gen)
    torch.cuda.synchronize()
    launches = read_counts()
    with (contextlib.nullcontext() if cases is None else capture(
            ["ms_deform_attn_fwd", "flash_attention_fwd"], cases)):
        tf = teacher_forced_logits(model, ids, images, n_img, att, tokens)
        with torch.no_grad():
            prep = model.prepare_mm_embeds(ids, images, n_img)
            hidden, _, _ = model.mm_decoder(
                prep["mm_embeds"], attention_mask=att,
                vision_hidden_states=prep["mmfs_values"],
                cross_attention_mask=prep["cross_attention_mask"])
            full = model.text_decoder(hidden).float()
    out = dict(tokens=tokens.cpu(), tf=tf.cpu(), full=full.cpu(),
               launches=launches)
    if not denoise:
        return out
    reset_counts()
    with (contextlib.nullcontext() if cases is None else capture(
            ["ms_deform_attn_fwd", "ms_deform_attn_mi_fwd",
             "flash_attention_fwd", "geglu_fwd"], cases)):
        inp = rt.generate_image_inputs(ids, images, n_img, att)
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 7)
        imgs = rt.denoise(*(x[:2] for x in inp), g,
                          num_inference_steps=SHARD_STEPS,
                          guidance_scale=GUIDANCE)
    torch.cuda.synchronize()
    out.update(images=imgs.float().cpu(), image_launches=read_counts())
    return out


def tensor_rank_main(rank: str, port: str, out_dir: str) -> int:
    """One rank of phase 17b (``chip_smoke.py --tensor-rank R PORT DIR``):
    gloo over two processes on the one card, ``make_mesh(1, 1, 2)``; the
    seeded 8-layer model with its image decoder cut by `ShardedGenerator`
    (its cut weights' bytes and all of its weights'), `tp_forward` with
    kernels 1, 4, 5 and 7 captured; then a second build
    quantized whole and cut (``quantize="int8"``), its greedy tokens with
    the int8 kernel's decode calls captured.  Rank 0 holds each captured
    kernel against its plain version at the local-head and local-K shapes.
    Saves ``DIR/rank{R}.pt``."""
    import torch
    import torch.distributed as dist

    from mm_interleaved_tpu_torch.parallel.inference import ShardedGenerator
    from mm_interleaved_tpu_torch.parallel.partition import make_mesh

    r = int(rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=r)
    # gloo carries the CUDA tensors' collectives between the two ranks
    x = torch.full((4,), float(r + 1), device="cuda")
    dist.all_reduce(x)
    y = torch.full((4,), float(r + 1), device="cuda")
    dist.broadcast(y, 0)
    parts = [torch.empty(2, device="cuda") for _ in range(2)]
    dist.all_gather(parts, torch.full((2,), float(r), device="cuda"))
    gloo = dict(all_reduce=x.tolist() == [3.0] * 4,
                broadcast=y.tolist() == [1.0] * 4,
                all_gather=[t.tolist() for t in parts] == [[0.0] * 2,
                                                           [1.0] * 2])
    mesh = make_mesh(1, 1, 2, "cuda")
    rt = ShardedGenerator(tp_model(), mesh)
    res = dict(gloo_cuda=gloo, cut_bytes=cut_bytes(rt.model, rt.cuts),
               layers_bytes=param_bytes(rt.model, r"^mm_decoder\.layers\."),
               rank_bytes=param_bytes(rt.model, ""), cuts=len(rt.cuts))
    cases = {}
    res.update(tp_forward(rt, cases))
    del rt
    torch.cuda.empty_cache()
    rt = ShardedGenerator(tp_model(), mesh, quantize="int8")
    from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig

    cfg = rt.model.cfg
    ids, images, n_img, att = prompt_inputs(cfg, "cuda")
    sites = {}
    reset_counts()
    with int8_capture(sites, "tp", max_rows=B):
        res["int8_tokens"] = rt.generate_texts(
            ids, images, n_img, att, TextGenerationConfig(
                max_new_tokens=TP_TOKENS, eos_token_ids=(),
                pad_token_id=cfg.special.pad_token_id)).cpu()
    torch.cuda.synchronize()
    res["int8_launches"] = read_counts()
    dist.barrier()
    dist.destroy_process_group()
    del rt
    if r == 0:
        check_local_heads("17b", cfg, cases, TP_SITES)
        for name, want in TP_SITES.items():
            res[name] = compare_kernel(name, cases[name], want)
        res["int8_linear"] = compare_int8(sites)
    torch.save(res, Path(out_dir) / f"rank{r}.pt")
    return 0


def run_tensor_parallel() -> dict:
    """Phase 17b: `ShardedGenerator` with tensor = 2 over two gloo
    processes on the one card (NCCL refuses two ranks on one device), the
    flagship's widths with ``TP_LAYERS`` LLM layers and the image decoder
    (each rank first checks that gloo carries CUDA tensors'
    ``all_reduce``, ``broadcast`` and ``all_gather``), against the
    one-process run of the same seeded model here: the teacher-forced
    logits, the prompt's (at its real tokens) and the ``SHARD_STEPS``-step
    images no farther from the same weights' fp32 ones than
    ``TP_ERR_FACTOR`` times the one-process bf16 run's distance (max and
    mean), the two ranks' equal, the first greedy token the one-process
    run's; each rank's cut weights (the LLM's, the towers' and the
    vocabulary's) half of their one-process bytes within 2%, and a rank's
    weights the plan's count (`rank_bytes`) exactly; each rank's launches,
    text and image windows, the count derived from the config; kernels 1,
    4, 5, 7 and the int8 kernel at the local-head and local-K shapes
    against their plain versions (rank 0).  Every failure is gathered; the
    phase fails after the last check.  Each rank's log is under
    ``build/smoke_tp/``."""
    import subprocess

    import torch

    from mm_interleaved_tpu_torch.parallel.inference import LocalGenerator
    from mm_interleaved_tpu_torch.parallel.partition import rank_bytes
    from mm_interleaved_tpu_torch.parallel.tensor import tensor_cuts

    t0 = time.perf_counter()
    model = tp_model()
    one = tp_forward(LocalGenerator(model))
    one_bytes = dict(cut=cut_bytes(model, tensor_cuts(model, {"tensor": 2})),
                     layers=param_bytes(model, r"^mm_decoder\.layers\."),
                     whole=param_bytes(model, ""),
                     plan=rank_bytes(model, {"tensor": 2}))
    one["int8_tokens"] = tp_forward(LocalGenerator(
        model, quantize="int8"), denoise=False)["tokens"]
    del model
    torch.cuda.empty_cache()
    # the same weights in fp32: the yardstick of both bf16 runs' rounding
    model = tp_model().float()
    ref = tp_forward(LocalGenerator(model))
    del model
    torch.cuda.empty_cache()
    out_dir = Path("build/smoke_tp")
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = str(free_port())
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tensor-rank", str(r),
         port, str(out_dir)], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        deadline = time.monotonic() + TP_TIMEOUT
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc:
                raise AssertionError(f"17b rank {r} exited {rc}: see "
                                     f"{out_dir}/rank{r}.log")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    res = dict(one_bytes=one_bytes, gloo_cuda=[rk["gloo_cuda"]
                                               for rk in ranks],
               cuts=ranks[0]["cuts"], plan_bytes=plan_bytes())
    fails = [f"rank {r}: gloo refused or garbled CUDA {k}"
             for r, rk in enumerate(ranks)
             for k, ok in rk["gloo_cuda"].items() if not ok]
    # the prompt logits at the real tokens (a padded slot's are noise)
    _, _, _, att = prompt_inputs(tp_config(), "cpu")
    valid = att.bool()
    for key in ("tf", "full"):
        sel = (lambda x: x[valid]) if key == "full" else (lambda x: x)
        want = sel(ref[key])
        for who, got in (("one", one[key]), ("tp", ranks[0][key])):
            err = (sel(got) - want).abs()
            res[f"{key}_{who}_max_err"] = float(err.max())
            res[f"{key}_{who}_mean_err"] = float(err.mean())
        res[f"{key}_scale"] = float(want.abs().max())
        res[f"{key}_tp_vs_one_max"] = float(
            (sel(ranks[0][key]) - sel(one[key])).abs().max())
        for stat in ("max", "mean"):
            tp_err = res[f"{key}_tp_{stat}_err"]
            one_err = res[f"{key}_one_{stat}_err"]
            if not tp_err <= TP_ERR_FACTOR * one_err:
                fails.append(f"{key} logits' {stat} error against fp32 "
                             f"{tp_err} over {TP_ERR_FACTOR} x the one-"
                             f"process bf16 run's {one_err}")
        if not torch.equal(ranks[1][key], ranks[0][key]):
            fails.append(f"{key} logits differ between ranks")
    for stat, fn in (("max", torch.max), ("mean", torch.mean)):
        tp_err = float(fn((ranks[0]["images"] - ref["images"]).abs()))
        one_err = float(fn((one["images"] - ref["images"]).abs()))
        res[f"images_tp_{stat}_err"] = tp_err
        res[f"images_one_{stat}_err"] = one_err
        if not tp_err <= TP_ERR_FACTOR * one_err:
            fails.append(f"images' {stat} error against fp32 {tp_err} over "
                         f"{TP_ERR_FACTOR} x the one-process bf16 run's "
                         f"{one_err}")
    res["images_tp_vs_one_max"] = float(
        (ranks[0]["images"] - one["images"]).abs().max())
    if not torch.equal(ranks[1]["images"], ranks[0]["images"]):
        fails.append("images differ between ranks")
    if not torch.isfinite(ranks[0]["images"]).all():
        fails.append("non-finite images")
    top2 = one["tf"][:, 0].topk(2, dim=-1).values
    res["first_token_margin"] = float((top2[:, 0] - top2[:, 1]).min())
    if not torch.equal(ranks[0]["tokens"][:, 0], one["tokens"][:, 0]):
        fails.append(f"first greedy token {ranks[0]['tokens'][:, 0]} != "
                     f"{one['tokens'][:, 0]}")
    res["tokens_equal"] = float((ranks[0]["tokens"] == one["tokens"])
                                .float().mean())
    res["int8_tokens_equal"] = float((ranks[0]["int8_tokens"]
                                      == one["int8_tokens"]).float().mean())
    for r, rk in enumerate(ranks):
        for key in ("cut", "layers"):
            res[f"rank{r}_{key}_ratio"] = rk[f"{key}_bytes"] / one_bytes[key]
        if abs(res[f"rank{r}_cut_ratio"] / 0.5 - 1) > 0.02:
            fails.append(f"rank {r}: cut weights {rk['cut_bytes']} B, not "
                         f"half of {one_bytes['cut']}")
        res[f"rank{r}_bytes"] = rk["rank_bytes"]
        if rk["rank_bytes"] != one_bytes["plan"]:
            fails.append(f"rank {r}: {rk['rank_bytes']} B of weights, the "
                         f"plan counts {one_bytes['plan']}")
    want = bench_text_launches(tp_config(), TP_TOKENS)
    want_image = expected_image_launches(tp_config(), SHARD_STEPS, 2)
    if one["image_launches"] != want_image:
        fails.append(f"one-process image launches {one['image_launches']} "
                     f"!= {want_image}")
    for r, rk in enumerate(ranks):
        if rk["launches"] != want:
            fails.append(f"rank {r} launches {rk['launches']} != {want}")
        if rk["image_launches"] != want_image:
            fails.append(f"rank {r} image launches {rk['image_launches']} "
                         f"!= {want_image}")
    if ranks[0]["int8_launches"]["int8_linear"] == 0:
        fails.append("the int8 kernel was not launched")
    if fails:
        log(f"phase 17b: {json.dumps(res)}")
        raise AssertionError("17b: " + "; ".join(fails))
    res.update(launches=add_launches(ranks[0]["launches"],
                                     ranks[0]["image_launches"]),
               int8_launches=ranks[0]["int8_launches"],
               sites={k: ranks[0][k] for k in (*TP_SITES, "int8_linear")},
               tokens=ranks[0]["tokens"][:, :TP_TOKENS].tolist(),
               wall_s=time.perf_counter() - t0)
    return res


# --------------------------------------------------------------------------
# the sharded Trainer (phase 18)

# 18b's batch: phase 8b's prompt cut to its first row (both tensor ranks
# run every row), its two target images at 512 px
TRAIN_TP_ROWS = 1


def _grad_spy(trainer, keep: dict):
    """Record ``trainer``'s fp32 gradients after the sums over the ranks
    (on the host, by leaf name) in ``keep``."""
    stats = trainer._global_stats

    def spy(loss, aux, grads):
        keep.update((n, g.detach().to("cpu", copy=True))
                    for n, g in zip(trainer.optimizer.names, grads))
        return stats(loss, aux, grads)

    trainer._global_stats = spy


def state_digests(trainer) -> dict:
    """A digest of every master and both moments of ``trainer``."""
    opt = trainer.optimizer
    out = {}
    for i, n in enumerate(opt.names):
        for kind, x in (("master", opt.masters[i]), ("m", opt.m[i]),
                        ("v", opt.v[i])):
            out[f"{kind} {n}"] = int(_digest(x))
    return out


def run_sharded_train_one() -> dict:
    """Phase 18a: the flagship's training form (phase 8's seed, config and
    batch) through `Trainer` on ``make_mesh(1, 1, 1)`` (a nccl group of one
    rank), one step, then the same step through the one-process `Trainer`
    on a model built again from the same seed: the loss, the gradient norm
    and every master and both moments (by digest) the same bits, each
    run's launches the count derived from the config.  Each model is freed
    before the next is built (the step peaks near 55 GB)."""
    import gc

    import torch
    import torch.distributed as dist

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model
    from mm_interleaved_tpu_torch.parallel.partition import make_mesh

    t0 = time.perf_counter()
    cfg = flagship_config(max_num_images=N_IMG)
    optim = OptimConfig(warmup_steps=0)
    want = expected_train_launches(cfg, B * N_IMG)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    out = {}
    try:
        for name in ("sharded", "local"):
            model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED,
                                optim=optim)
            perturb_zero_inits(model, SEED + 1)
            mesh = make_mesh(1, 1, 1, "cuda") if name == "sharded" else None
            trainer = Trainer(model, TrainerConfig(optim=optim), "cuda",
                              mesh=mesh)
            batch = train_inputs(cfg, "cuda")
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launches = read_counts()
            if launches != want:
                raise AssertionError(f"18a {name} launches {launches} != "
                                     f"{want}")
            out[name] = dict(metrics=metrics, ms=ms, launches=launches,
                             digests=state_digests(trainer),
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            del model, trainer, batch
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    finally:
        dist.destroy_process_group()
    sh, loc = out["sharded"], out["local"]
    for k in ("loss", "grad_norm", "loss_txt", "loss_img"):
        if sh["metrics"][k] != loc["metrics"][k]:
            raise AssertionError(f"18a {k}: sharded {sh['metrics'][k]!r} != "
                                 f"one-process {loc['metrics'][k]!r}")
    differ = [k for k, d in loc["digests"].items()
              if sh["digests"].get(k) != d]
    if differ or set(sh["digests"]) != set(loc["digests"]):
        raise AssertionError(f"18a: {len(differ)} masters/moments differ "
                             f"from the one-process step's: {differ[:4]}")
    if not all(np.isfinite(v) for v in sh["metrics"].values()):
        raise AssertionError(f"18a: non-finite metrics {sh['metrics']}")
    return dict(metrics=sh["metrics"], ms=(loc["ms"], sh["ms"]),
                peak_gb=(loc["peak_gb"], sh["peak_gb"]),
                launches=sh["launches"], leaves=len(loc["digests"]) // 3,
                wall_s=time.perf_counter() - t0)


def train_tp_config():
    """18b's model: the flagship's widths with ``TP_LAYERS`` LLM layers (2
    MMFS) and its image decoder."""
    import dataclasses as dc

    from mm_interleaved_tpu_torch.configs import flagship_config

    cfg = flagship_config(max_num_images=N_IMG)
    return dc.replace(cfg, llm=dc.replace(cfg.llm,
                                          num_hidden_layers=TP_LAYERS))


def train_tp_step(dtype, mesh=None, cases=None) -> dict:
    """One step of 18b's seeded model (built in bf16, then cast to
    ``dtype``) on the first ``TRAIN_TP_ROWS`` rows of phase 8b's batch, by
    `Trainer` (on ``mesh`` when given): the metrics, the summed fp32
    gradients by leaf (host), the launches (counts at 0 before, read after)
    and the cut leaves' names; kernels 1, 2, 3, 5 and 5b captured at the
    LLM's and the towers' sites into ``cases`` when given."""
    import torch

    from mm_interleaved_tpu_torch.engine.optim import OptimConfig
    from mm_interleaved_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    cfg = train_tp_config()
    optim = OptimConfig(warmup_steps=0)
    model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED, optim=optim)
    perturb_zero_inits(model, SEED + 1)
    model = model.to(dtype)
    trainer = Trainer(model, TrainerConfig(optim=optim), "cuda", mesh=mesh)
    rows = slice(0, TRAIN_TP_ROWS)
    batch = {k: v[rows] for k, v in train_inputs(cfg, "cuda").items()}
    grads = {}
    _grad_spy(trainer, grads)
    names = ["ms_deform_attn_fwd", "flash_attention_fwd", *BACKWARD]
    torch.cuda.synchronize()
    reset_counts()
    with (contextlib.nullcontext() if cases is None
          else capture(names, cases)):
        metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    launches = read_counts()
    cuts = sorted(trainer.layout.cuts) if trainer.layout is not None else []
    res = dict(metrics=metrics, grads=grads, launches=launches, cuts=cuts,
               labels=dict(zip(trainer.optimizer.names,
                               trainer.optimizer.labels)))
    if trainer.layout is not None:
        # the cut leaves' gradients whole (a collective on both ranks)
        for n in cuts:
            if n in grads:
                grads[n] = trainer.layout.gather(
                    n, grads[n].to("cuda")).to("cpu")
    del model, trainer
    torch.cuda.empty_cache()
    return res


def train_tensor_rank_main(rank: str, port: str, out_dir: str) -> int:
    """One rank of phase 18b (``chip_smoke.py --train-tensor-rank R PORT
    DIR``): gloo over two processes on the one card, ``make_mesh(1, 1,
    2)``, `train_tp_step` in bf16 with kernels 1, 2, 3, 5 and 5b captured;
    rank 0 holds each against its plain version at the LLM's and the
    towers' local-head sites (`TRAIN_TP_SITES`) and saves its gradients; each rank saves a digest of each
    gradient of a leaf the plan keeps whole over ``tensor``, to
    ``DIR/rank{R}.pt``."""
    import torch
    import torch.distributed as dist

    from mm_interleaved_tpu_torch.parallel.partition import make_mesh

    r = int(rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=r)
    cases = {}
    res = train_tp_step(torch.bfloat16, make_mesh(1, 1, 2, "cuda"), cases)
    dist.barrier()
    dist.destroy_process_group()
    res["whole_digests"] = {n: int(_digest(g)) for n, g in
                            res["grads"].items() if n not in res["cuts"]}
    if r == 0:
        check_local_heads("18b", train_tp_config(), cases, TRAIN_TP_SITES)
        for name, want in TRAIN_TP_SITES.items():
            # the training forward keeps its LSE for the backward; the
            # comparison is of the output
            one = {site: (cases[name][site][0],
                          {k: v for k, v in cases[name][site][1].items()
                           if k != "return_lse"}) for site in want}
            compare = compare_kernel if name in FORWARD else compare_backward
            res[name] = compare(name, one, want)
    else:
        res.pop("grads")
    torch.save(res, Path(out_dir) / f"rank{r}.pt")
    return 0


def _errs(got: dict, want: dict, names) -> tuple:
    """The max and mean absolute differences over the leaves ``names``."""
    mx, tot, n = 0.0, 0.0, 0
    for k in names:
        d = (got[k].double() - want[k].double()).abs()
        mx = max(mx, float(d.max()))
        tot += float(d.sum())
        n += d.numel()
    return mx, tot / max(n, 1)


def run_train_tensor_parallel() -> dict:
    """Phase 18b: `Trainer` with tensor = 2 over two gloo processes on the
    card (``train_tensor_rank_main``), 18b's model (the flagship's widths,
    ``TP_LAYERS`` LLM layers, the image decoder), one step on one row of
    phase 8b's batch, against the one-process step of the same seeded
    weights in bf16 and in fp32 (the yardstick): the loss, the gradient
    norm and each trainable group's summed gradient (max and mean
    difference) no farther from the fp32 step than ``TP_ERR_FACTOR`` times
    the bf16 one-process step (a scalar at least half a bf16 ulp of its
    value: one scalar's bf16 distance may be near 0 by chance, where a
    group's max and mean over many entries are not); the gradient of every
    leaf kept whole over ``tensor`` the same bits on both ranks, and the
    towers cut; each rank's launches the one-process step's, which are the
    count derived from the config; kernels 1, 2, 3, 5 and 5b at the LLM's
    and the towers' local heads against their plain versions (rank 0).  Every failure is
    gathered; the phase fails after the last check.  Rank logs under
    ``build/smoke_train_tp/``."""
    import subprocess

    import torch

    t0 = time.perf_counter()
    one = train_tp_step(torch.bfloat16)
    ref = train_tp_step(torch.float32)
    out_dir = Path("build/smoke_train_tp")
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = str(free_port())
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--train-tensor-rank",
         str(r), port, str(out_dir)], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        deadline = time.monotonic() + TP_TIMEOUT
        for r, p in enumerate(procs):
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if rc:
                raise AssertionError(f"18b rank {r} exited {rc}: see "
                                     f"{out_dir}/rank{r}.log")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    tp = ranks[0]
    fails = []
    res = dict(metrics=dict(tp=tp["metrics"], one=one["metrics"],
                            fp32=ref["metrics"]))
    for k in ("loss", "grad_norm"):
        want = ref["metrics"][k]
        tp_err = abs(tp["metrics"][k] - want)
        one_err = abs(one["metrics"][k] - want)
        floor = _ulps(abs(want), 0.5)
        res[f"{k}_err"] = dict(tp=tp_err, one=one_err, floor=floor)
        if not tp_err <= max(TP_ERR_FACTOR * one_err, floor):
            fails.append(f"{k} {tp['metrics'][k]!r}: {tp_err} from fp32 over "
                         f"{TP_ERR_FACTOR} x the one-process bf16 step's "
                         f"{one_err} (floor {floor})")
    groups = {}
    for n, lab in one["labels"].items():
        groups.setdefault(lab, []).append(n)
    res["groups"] = {}
    for lab, names in sorted(groups.items()):
        t_max, t_mean = _errs(tp["grads"], ref["grads"], names)
        o_max, o_mean = _errs(one["grads"], ref["grads"], names)
        res["groups"][lab] = dict(leaves=len(names), tp_max=t_max,
                                  one_max=o_max, tp_mean=t_mean,
                                  one_mean=o_mean)
        for stat, t, o in (("max", t_max, o_max), ("mean", t_mean, o_mean)):
            if not t <= TP_ERR_FACTOR * o:
                fails.append(f"group {lab} gradient {stat} error {t} over "
                             f"{TP_ERR_FACTOR} x the one-process bf16 "
                             f"step's {o}")
    d0, d1 = ranks[0]["whole_digests"], ranks[1]["whole_digests"]
    res["whole_leaves"] = len(d0)
    uneq = sorted(n for n in d0 if d1.get(n) != d0[n])
    if uneq or set(d0) != set(d1):
        fails.append(f"{len(uneq)} gradients of leaves whole over tensor "
                     f"differ between the ranks: {uneq[:4]}")
    for tower in ("visual_tokenizer.", "image_decoder.unet.",
                  "image_decoder.perceiver_resampler."):
        if not any(n.startswith(tower) for n in tp["cuts"]):
            fails.append(f"no leaf of {tower} is cut over tensor")
        if not any(n.startswith(tower) for n in d0):
            fails.append(f"no whole leaf of {tower} was compared between "
                         "the ranks")
    derived = expected_train_launches(train_tp_config(),
                                      TRAIN_TP_ROWS * N_IMG)
    if one["launches"] != derived:
        fails.append(f"one-process launches {one['launches']} != {derived}")
    for r, rk in enumerate(ranks):
        if rk["launches"] != one["launches"]:
            fails.append(f"rank {r} launches {rk['launches']} != the one-"
                         f"process step's {one['launches']}")
    if fails:
        log(f"phase 18b: {json.dumps(res)}")
        raise AssertionError("18b: " + "; ".join(fails))
    res.update(launches=tp["launches"], cut_leaves=len(tp["cuts"]),
               sites={k: tp[k] for k in ("ms_deform_attn_fwd",
                                         "flash_attention_fwd", *BACKWARD)},
               wall_s=time.perf_counter() - t0)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    from mm_interleaved_tpu_torch.configs import flagship_config
    from mm_interleaved_tpu_torch.models.mm_interleaved import build_model

    # 1. environment
    smi = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device: {torch.cuda.get_device_name(0)} | {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    walls, t_lap = {}, [time.perf_counter()]

    def lap(name):
        """The wall of the phase that ends here."""
        now = time.perf_counter()
        walls[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # 2. build
    from mm_interleaved_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    names = cuda_build.build_all()
    log(f"built {names} in {time.perf_counter() - t0:.1f} s")

    shutil.rmtree(sites_dir(), ignore_errors=True)

    lap("2 build")
    # 3. small reference
    cases = {}
    ref = small_reference(cases)
    log(f"small reference (tiny, fp32, card vs CPU): {json.dumps(ref)}")
    tref = small_training_reference(cases)
    log(f"small training reference (tiny, fp32, one AdamW step, card vs "
        f"CPU): {json.dumps(tref)}")

    lap("3 small reference")
    # 4. the flagship model with its image decoder
    cfg = flagship_config(max_num_images=N_IMG)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", torch.bfloat16, seed=SEED)
    perturb_zero_inits(model, SEED + 1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_dec = sum(p.numel() for p in model.image_decoder.parameters())
    log(f"flagship: {n_params / 1e9:.3f} B params ({n_dec / 1e9:.3f} B in "
        f"the image decoder), bf16, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    # 5. the text slice
    res = run_text_slice(model, "cuda", cases)
    log(f"text slice: B={B} prompt={PROMPT_LEN} images/row={N_IMG} "
        f"new_tokens={NEW_TOKENS}: prefill (encode + LLM prefill + first "
        f"token) {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms']:.2f} ms/token, generate_texts "
        f"{res['gen_ms']:.1f} ms, peak memory {res['peak_gb']:.2f} GB, "
        f"launches {json.dumps(res['launches'])}")
    log(f"tokens[0][:16] = {res['tokens'][0, :16].tolist()}")

    # 6. the image slice
    img = run_image_slice(model, "cuda", cases)
    log(f"image slice: {B * N_IMG} images at "
        f"{cfg.image_decoder.image_size} px, {IMG_STEPS} DDPM steps, "
        f"guidance {GUIDANCE}: generate_image_inputs "
        f"{img['inputs_ms']:.1f} ms, denoise {img['step_ms']:.1f} ms/step, "
        f"VAE decode {img['vae_decode_ms']:.1f} ms, total "
        f"{img['total_ms']:.1f} ms, peak memory {img['peak_gb']:.2f} GB")
    log(f"image slice launches {json.dumps(img['launches'])} "
        f"(derived {json.dumps(img['expected'])}); MMFS moved the rows by "
        f"{img['mmfs_moved']}")
    prof = profile_step(model, "cuda")
    log(f"one denoise step (torch.profiler): device time "
        f"{prof['device_ms']:.1f} ms, {prof['launches']} kernel launches, "
        f"busy share {prof['device_ms'] / img['step_ms']:.2f} of the "
        f"unprofiled step; by kernel {json.dumps(prof['top'])}")
    del model
    torch.cuda.empty_cache()

    lap("4-6 flagship slices")
    # 7. each kernel against its plain version at the captured shapes
    launches = dict(img["launches"])
    launches["ms_deform_attn_fwd"] = res["launches"]["ms_deform_attn_fwd"]
    lines = [kernel_line(name, compare_kernel(name, cases[name]),
                         launches[name]) for name in FORWARD
             if name not in GN]
    gn = compare_group_norm(cases["group_norm"],
                            gn_site_keys(cfg, B * N_IMG) + [TINY])
    lines += [kernel_line(name, gn[name], launches[name]) for name in GN]
    line_of = {line["name"]: line for line in lines}
    line_of["flash_attention_fwd"]["edge_cases"] = check_flash_edges(False)
    line_of["geglu_fwd"]["edge_cases"] = check_geglu_edges()
    line_of["ms_deform_attn_mi_fwd"]["edge_cases"] = check_mi_edges()
    line_of["group_norm_moments"]["whole_op"] = whole_op_sums(
        gn["group_norm_moments"])
    line_of["group_norm_moments"]["edge_cases"] = check_gn_edges()
    log("captured sites of kernels 4 and 7 and GroupNorm saved to "
        + save_sites(cases, ("geglu_fwd", "ms_deform_attn_mi_fwd",
                             "group_norm")))
    # nothing reads the GroupNorm inputs again (1.6 GB at the flagship's
    # sites); held through phase 8 they would count in its peak memory
    freed = sum(a.numel() * a.element_size()
                for args, _ in cases.pop("group_norm").values()
                for a in args if isinstance(a, torch.Tensor))
    log(f"captured GroupNorm inputs freed: {freed / 1e9:.3f} GB")

    lap("7 kernels vs plain")
    # 8. the flagship training step, then the backward kernels against
    # their plain versions at the captured shapes
    tr = run_training("cuda", cases)
    m = tr["metrics"]
    log(f"training: B={B} rows of {PROMPT_LEN} tokens, {B * N_IMG} target "
        f"images at {cfg.image_decoder.image_size} px, {TRAIN_STEPS} AdamW "
        f"steps: {[round(x, 1) for x in tr['step_ms']]} ms/step, peak "
        f"memory {tr['peak_gb']:.2f} GB ({tr['held_gb']:.2f} GB held before "
        f"the build); loss {[x['loss'] for x in m]}, "
        f"loss_txt {[x['loss_txt'] for x in m]}, loss_img "
        f"{[x['loss_img'] for x in m]}, grad_norm "
        f"{[x['grad_norm'] for x in m]}")
    log(f"training step 1 twice, the same bits: "
        f"{json.dumps(tr['step1_same'])}; "
        f"groups moved {json.dumps(tr['moved'])}; launches "
        f"{json.dumps(tr['launches'])} (derived {json.dumps(tr['expected'])})")
    log(f"one training step (torch.profiler): device time "
        f"{tr['device_ms']:.1f} ms, {tr['profiled_launches']} kernel "
        f"launches, busy share {tr['busy']:.2f} of the unprofiled step; by "
        f"kernel {json.dumps(tr['top'])}")
    lines += [kernel_line(name, compare_backward(name, cases[name]),
                          tr["launches"][name]) for name in BACKWARD]
    line_of.update((line["name"], line) for line in lines)
    line_of["flash_attention_bwd"]["edge_cases"] = check_flash_edges(True)
    line_of["ms_deform_attn_fwd"]["training_sites"] = \
        check_forward_at_training_sites(cases["ms_deform_attn_bwd_value"])
    edges = check_deform_bwd_edges()
    for name in ("ms_deform_attn_fwd", "ms_deform_attn_bwd_value",
                 "ms_deform_attn_bwd_loc_weight"):
        line_of[name]["edge_cases"] = edges
    log("captured sites of kernels 1, 2 and 3 saved to "
        + save_sites(cases, ("ms_deform_attn_fwd", "ms_deform_attn_bwd_value",
                             "ms_deform_attn_bwd_loc_weight")))

    lap("8 training step and backward kernels")
    # 9. the deformable-kernel benchmark
    lines += run_bench_phase()
    lap("9 deformable benchmark")
    # 10. the v4-against-v5 benchmark, forward and backward
    lines += run_v5_bench_phase()
    lap("10 v4 against v5")
    # the captured inputs are compared and saved: free them for the
    # entry points
    cases.clear()
    torch.cuda.empty_cache()

    # 11. the training entry point on the flagship, then the resume check
    te = run_train_entry()
    log(f"train entry: flagship from the YAML, {te['images']} image slots "
        f"a step, {SMOKE_TRAIN_STEPS} steps: "
        f"{[round(x, 1) for x in te['step_ms']]} ms/step, peak memory "
        f"{te['peak_gb']:.2f} GB, {te['trainable'] / 1e9:.3f} B trainable; "
        f"data path {[round(x, 1) for x in te['host_ms']]} host ms a batch "
        f"(native kernels: {te['native']}); losses "
        f"{[m['loss'] for _, m in te['logged']]}, grad norms "
        f"{[m['grad_norm'] for _, m in te['logged']]}; groups moved "
        f"{json.dumps(te['moved'])}; launches {json.dumps(te['launches'])}")
    log(f"train entry: final checkpoint {te['checkpoint_gb']:.3f} GB written "
        f"in {te['save_s']:.1f} s ({te['free_gb']:.0f} GB free before the "
        f"run; deleted); run {te['run_s']:.1f} s; tiny "
        f"resume from step 2, step 3 the same bits: "
        f"{json.dumps(te['resume'])} ({te['resume_s']:.1f} s); phase 11 "
        f"{te['wall_s']:.1f} s")
    lap("11 train entry")
    # 12. the interleaved-turn benchmark at the base preset
    bt = run_bench_turn()
    log(f"bench: {json.dumps(bt['line'])}")
    log(f"bench launches {json.dumps(bt['launches'])}, one timed turn "
        f"(measured) {json.dumps(bt['turn'])}; phase 12 "
        f"{bt['wall_s']:.1f} s")
    lap("12 bench turn")
    # 13. the training-step benchmark, small and base
    btr = run_bench_train()
    log(f"bench_train: {json.dumps(btr['line'])}")
    log(f"bench_train launches {json.dumps(btr['launches'])}; phase 13 "
        f"{btr['wall_s']:.1f} s")
    lap("13 bench_train")
    # 14. the serving path at the flagship: beam search, the inference
    # entry point, the evaluation entry point
    sv = run_serving(res["tokens"])
    for name, r in sv["beam"].items():
        if name == "k1_equals_greedy":
            continue
        log(f"beam {name}: K={r['num_beams']}, {r['new_tokens']} tokens, "
            f"B={B}: {r['beam_ms_per_token']:.2f} ms/token (greedy "
            f"{r['greedy_ms_per_token']:.2f}), first token "
            f"{r['beam_first_ms']:.1f} ms (greedy {r['greedy_first_ms']:.1f}),"
            f" peak memory {r['beam_peak_gb']:.2f} GB (greedy "
            f"{r['greedy_peak_gb']:.2f}); launches {json.dumps(r['launches'])}"
            f"; tokens[:, :8] {r['tokens']}")
    log(f"beam K=1 equals phase 5's greedy tokens: "
        f"{sv['beam']['k1_equals_greedy']}")
    inf = sv["inference"]
    log(f"inference entry: turns {json.dumps(inf['turns'])} (ms), texts "
        f"{inf['texts']}, PNG {inf['png_shape']}, peak memory "
        f"{inf['peak_gb']:.2f} GB, {inf['wall_s']:.1f} s; launches "
        f"{json.dumps(inf['launches'])} (text turn "
        f"{json.dumps(inf['text_turn'])}, image turn "
        f"{json.dumps(inf['image_turn'])})")
    for route, r in sv["eval"]["routes"].items():
        log(f"eval {route} ({r['dataset']}): {r['samples']} samples in "
            f"{r['ms']:.1f} ms, {r['samples_per_s']:.3f} samples/s; "
            f"{json.dumps(r['row'])}")
    log(f"eval entry: peak memory {sv['eval']['peak_gb']:.2f} GB, "
        f"{sv['eval']['wall_s']:.1f} s; launches "
        f"{json.dumps(sv['eval']['launches'])}; phase 14 "
        f"{sv['wall_s']:.1f} s (flagship built in {sv['build_s']:.1f} s)")
    serving = add_launches(
        *(r["launches"] for k, r in sv["beam"].items()
          if k != "k1_equals_greedy"),
        inf["launches"], sv["eval"]["launches"])
    log(f"inference entry's first text turn, this process against a fresh "
        f"one (the texts equal; the native pixels the CPU's): "
        f"{json.dumps(sv['turn'])}")
    lap("14 serving")
    # 15. weights from files: the converter in both modes, load_model, the
    # warm start, the CLIP towers of the rerank, InceptionV3
    wt = run_weights_phase()
    rel, tow, warm = wt["released"], wt["towers"], wt["warm"]
    for mode, r in (("released-model", rel), ("tower", tow)):
        c = r["convert"]
        log(f"convert ({mode} mode, flagship widths, {WEIGHT_LAYERS} LLM "
            f"layers): source {r['source']['bytes'] / 1e9:.3f} GB in "
            f"{r['source']['files']} safetensors files (written in "
            f"{r['source']['write_s']:.1f} s); {c['converted']} tensors, "
            f"{c['source_bytes'] / 1e9:.3f} GB streamed in "
            f"{c['stream_s']:.2f} s ({c['stream_gb_per_s']:.3f} GB/s), "
            f"output {c['out_bytes'] / 1e9:.3f} GB saved in "
            f"{c['save_s']:.2f} s, process {c['process_s']:.1f} s, peak host "
            f"RSS {c['peak_rss_gb']:.3f} GB ({c['rss_built_gb']:.3f} GB after "
            f"the build); every tensor equal to its "
            f"source ({r['check']['checked']} checked in "
            f"{r['check']['check_s']:.1f} s) | {smi}")
    log(f"load_model of the released-model output: {rel['load_s']:.2f} s "
        f"({rel['model_params'] / 1e9:.3f} B params) | {smi}; text slice "
        f"({WEIGHT_TOKENS} tokens) {rel['slices']['text_ms']:.1f} ms, "
        f"denoise ({WEIGHT_STEPS} CFG steps, {B * N_IMG} images) "
        f"{rel['slices']['image_ms']:.1f} ms, launches "
        f"{json.dumps(rel['slices']['launches'])}; tokens[:, :8] "
        f"{rel['slices']['tokens']}")
    log(f"tower mode: padded embedding rows {tow['pad_err']} from the mean "
        f"(tolerance {tow['pad_tol']}), TextDecoder heads "
        f"{json.dumps(tow['heads'])}")
    log(f"warm start (train.main, load_from the tower output, 1 step): "
        f"{json.dumps(warm['seen'])}, metrics {json.dumps(warm['metrics'])}, "
        f"launches {json.dumps(warm['launches'])}, run {warm['run_s']:.1f} s")
    clip = wt["clip"]
    log(f"CLIP text tower (768 wide, 12 layers, 77 tokens, fp32): "
        f"{clip['text_ms']:.3f} ms per {CLIP_CAPTIONS} captions | {smi}; "
        f"projected image features of {clip['images']} images "
        f"{clip['image_ms']:.1f} ms; card vs CPU {json.dumps(clip['errors'])}"
        f"; rerank picks {clip['picks']} (the CPU's)")
    inc = wt["inception"]
    log(f"InceptionV3 (299 px, fp32): {inc['ms_per_image']:.3f} ms per image "
        f"({INCEPTION_IMAGES} a batch) | {smi}; card vs CPU "
        f"{inc['max_abs_err']} at scale {inc['scale']} (limit 1e-5 of it; "
        f"with cuDNN's TF32 convolutions {inc['tf32_max_abs_err']}); phase 15 "
        f"{wt['wall_s']:.1f} s")
    lap("15 weights")
    # 16. int8 weight-only decode, the benchmark datasets, RICES
    qp = run_quant_phase(res["tokens"], res["peak_gb"], res["decode_ms"])
    t16, f16 = qp["tiny"], qp["flagship"]
    log(f"int8 tiny (fp32, card vs CPU, {t16['quantized']} layers): logits "
        f"{t16['logits_max_abs_err']} at scale {t16['logits_scale']} (limit "
        f"1e-4 of it), greedy tokens the CPU's (top-2 margin "
        f"{t16['top2_margin']}), {t16['launches']} int8 launches")
    log(f"int8 flagship: {f16['quantized']} layers quantized in "
        f"{f16['quantize_s']:.2f} s, LLM projections {f16['llm_bf16_gb']:.3f} "
        f"-> {f16['llm_int8_gb']:.3f} GB, held {f16['held_gb']:.2f} GB | "
        f"{smi}; text slice peak {f16['peak_gb']:.2f} GB (bf16, phase 5: "
        f"{f16['bf16_peak_gb']:.2f} GB), first token {f16['first_ms']:.1f} "
        f"ms, decode {f16['decode_ms']:.2f} ms/token (bf16, phase 5: "
        f"{f16['bf16_decode_ms']:.2f}; the int8 weights' bound "
        f"{f16['decode_bound_ms']:.3f} ms/token), tokens equal to bf16's at "
        f"{f16['tokens_equal_bf16']:.3f} of positions; beam K=3 "
        f"{f16['beam_ms']:.1f} ms; denoise ({QUANT_STEPS} CFG steps) "
        f"{f16['image_ms']:.1f} ms; launches {json.dumps(f16['launches'])}")
    be = qp["bench_eval"]
    for name, r in be["routes"].items():
        log(f"bench eval {name} ({r['route']}): {r['samples']} samples in "
            f"{r['ms']:.1f} ms, {r['samples_per_s']:.3f} samples/s; "
            f"{json.dumps(r['row'])}")
    log(f"bench eval: peak memory {be['peak_gb']:.2f} GB, {be['wall_s']:.1f} "
        f"s; segm2img with the palette segmenter {json.dumps(be['segm'])}; "
        f"nocaps with quantize int8 {json.dumps(be['int8_caption'])}; "
        f"launches {json.dumps(be['launches'])}")
    log(f"RICES ({RICES_SUPPORT} support images, {RICES_QUERIES} queries, "
        f"top {RICES_K}, ViT-L/14 fp32): {json.dumps(qp['rices'])}")
    log(f"phase 16 {qp['wall_s']:.1f} s")
    int8_line = kernel_line("int8_linear", qp["sites"],
                            f16["launches"]["int8_linear"])
    int8_line["edge_cases"] = qp["edges"]
    lines.append(int8_line)
    quant_launches = add_launches(f16["launches"], be["launches"])
    line_of["flash_attention_fwd"]["clip_text_site"] = clip["site"]
    lap("16 int8 and datasets")
    # 17. the sharded runtime: (a) world size 1 at the flagship, (b) tensor
    # = 2 over two processes on the card
    sh = run_sharded_one()
    log(f"sharded runtime, world size 1 (nccl, mesh (1, 1, 1), flagship): "
        f"greedy tokens and the first two images of row 0 equal "
        f"LocalGenerator's bit for bit; text {sh['text_ms'][1]:.1f} ms "
        f"(local {sh['text_ms'][0]:.1f}), {SHARD_STEPS}-step denoise "
        f"{sh['image_ms'][1]:.1f} ms (local {sh['image_ms'][0]:.1f}) | "
        f"{smi}; launches {json.dumps(sh['launches'])}; phase 17a "
        f"{sh['wall_s']:.1f} s")
    tp = run_tensor_parallel()
    errs = {k: v for k, v in tp.items() if k.startswith(("tf_", "full_"))}
    errs.update({k: v for k, v in tp.items() if k.startswith("images_")})
    log(f"tensor parallel, tensor = 2 (gloo, two processes on the card, "
        f"{TP_LAYERS} LLM layers at the flagship's widths with the image "
        f"decoder, {tp['cuts']} leaves cut): logits and {SHARD_STEPS}-step "
        f"images against the fp32 one-process run {json.dumps(errs)}; a "
        f"rank's weights {tp['rank0_bytes'] / 1e9:.4f} GB (the plan's count; "
        f"one process {tp['one_bytes']['whole'] / 1e9:.4f}); the flagship "
        f"under the plan (meta, bytes a rank) "
        f"{json.dumps(tp['plan_bytes'])}; first greedy token "
        f"equal (top-2 "
        f"margin {tp['first_token_margin']:.4g}), {TP_TOKENS} tokens equal "
        f"at {tp['tokens_equal']:.3f} of positions, int8 at "
        f"{tp['int8_tokens_equal']:.3f}; cut weights a rank "
        f"{tp['rank0_cut_ratio']:.4f} / {tp['rank1_cut_ratio']:.4f} of "
        f"{tp['one_bytes']['cut'] / 1e9:.3f} GB, the layers' "
        f"{tp['rank0_layers_ratio']:.4f} of "
        f"{tp['one_bytes']['layers'] / 1e9:.3f} GB; gloo's CUDA "
        f"collectives {json.dumps(tp['gloo_cuda'])} | {smi}; launches "
        f"{json.dumps(tp['launches'])}, int8 "
        f"{json.dumps(tp['int8_launches'])}; phase 17b {tp['wall_s']:.1f} s")
    for name in TP_SITES:
        line_of[name]["tensor_parallel_sites"] = tp["sites"][name]
    int8_line["tensor_parallel_sites"] = tp["sites"]["int8_linear"]
    lap("17 sharded runtime")
    # 18. the sharded Trainer: (a) world size 1 at the flagship against the
    # one-process Trainer, (b) tensor = 2 over two processes on the card
    st = run_sharded_train_one()
    log(f"sharded Trainer, world size 1 (nccl, mesh (1, 1, 1), flagship "
        f"training form, phase 8b's batch, 1 step): loss, grad norm and the "
        f"masters and moments of {st['leaves']} leaves equal the one-"
        f"process Trainer's bit for bit; metrics {json.dumps(st['metrics'])};"
        f" step {st['ms'][1]:.1f} ms (one-process {st['ms'][0]:.1f}), peak "
        f"{st['peak_gb'][1]:.2f} GB (one-process {st['peak_gb'][0]:.2f}) | "
        f"{smi}; launches {json.dumps(st['launches'])}; phase 18a "
        f"{st['wall_s']:.1f} s")
    ttp = run_train_tensor_parallel()
    log(f"sharded Trainer, tensor = 2 (gloo, two processes on the card, "
        f"{TP_LAYERS} LLM layers at the flagship's widths with the image "
        f"decoder, {TRAIN_TP_ROWS} row): loss and grad norm against the fp32 "
        f"one-process step {json.dumps({k: ttp[k] for k in ('loss_err', 'grad_norm_err')})}; "
        f"each group's gradient {json.dumps(ttp['groups'])}; "
        f"{ttp['whole_leaves']} leaves whole over tensor, the same gradient "
        f"bits on both ranks; {ttp['cut_leaves']} cut; metrics "
        f"{json.dumps(ttp['metrics'])} | {smi}; launches "
        f"{json.dumps(ttp['launches'])}; phase 18b {ttp['wall_s']:.1f} s")
    for name, recs in ttp["sites"].items():
        line_of[name]["train_tensor_parallel_sites"] = recs
    lap("18 sharded Trainer")
    log(f"phase walls (s): {json.dumps(walls)}; in all "
        f"{sum(walls.values()):.1f} s")
    for line in lines:
        line["sharded_launches"] = sh["launches"][line["name"]]
        line["sharded_train_launches"] = st["launches"][line["name"]]
        line["train_tensor_parallel_launches"] = ttp["launches"][line["name"]]
        line["tensor_parallel_launches"] = (
            tp["launches"][line["name"]] + tp["int8_launches"][line["name"]])
        line["quant_launches"] = quant_launches[line["name"]]
        line["weights_launches"] = wt["launches"][line["name"]]
        line["serving_launches"] = serving[line["name"]]
        line["bench_turn_launches"] = bt["turn"][line["name"]]
        per_step = te["launches"][line["name"]] / SMOKE_TRAIN_STEPS
        line["train_entry_step_launches"] = (
            int(per_step) if per_step == int(per_step) else per_step)
    log(json.dumps({"kernels": lines}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tensor-rank"]:
        sys.exit(tensor_rank_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--turn-probe"]:
        sys.exit(turn_probe_main(*sys.argv[2:]))
    if sys.argv[1:2] == ["--train-tensor-rank"]:
        sys.exit(train_tensor_rank_main(*sys.argv[2:]))
    sys.exit(main())
