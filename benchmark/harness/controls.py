"""The controls of the check: the reference put in the program's place,
with its weights rounded to the precision below the configuration's
(bf16 -> float8 e4m3 with a scale an output row; the int8 projections ->
int4), on the units and rows the check samples.  A control has to come
out not correct; `benchmark/tests/test_bench_chip_controls.py` runs them
on the card.

* images: the control's images of the sampled requests replace the
  program's;
* texts: the control need not decode: at the same prompts and served
  tokens, its log-probabilities replace the program's kept ones (the
  prefill's last position and the first decode step's), and the token it
  puts first at each position is the one whose rank the check reads."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from . import check, models
from ..reference import quant


def rounding(config: dict):
    """``transform(name, w)`` of the control: every matrix and kernel in
    float8 for a bf16 configuration; the int8 projections in int4 for the
    int8 deployment."""
    if config.get("quantize") == "int8":
        names: set = set()

        def int4(name, w):
            return quant.int4_roundtrip(w) if name in names else w

        int4.names = names
        return int4

    def fp8(name, w):
        return quant.fp8_roundtrip(w) if w.dim() >= 2 else w

    return fp8


def control_model(cell, image_decoder: bool):
    transform = rounding(cell.config)
    if hasattr(transform, "names"):
        from ..reference.models.mm_interleaved import MMInterleaved

        with torch.device("meta"):
            shape = MMInterleaved(models.reference_config(cell.config,
                                                          image_decoder))
        transform.names.update(quant.quantized_weights(shape))
    return models.reference(cell.config, cell.seed, cell.device,
                            image_decoder=image_decoder, transform=transform)


def apply(cell, finished: List[int], outputs: Dict[int, torch.Tensor],
          captured) -> None:
    """Put the control's outputs in place of the program's for what the
    check samples."""
    tr = cell.traffic
    spec = tr.spec
    with check.full_fp32():
        if tr.entry == "generate_images":
            ctl = control_model(cell, True)
            (i,) = check.sample_units(cell.seed, finished, 1)
            rows = check.image_rows(cell.seed, tr.unit(i),
                                    spec["check_images"])
            outputs[i][rows] = check.reference_images(ctl, tr, i, rows)
        else:
            ctl = control_model(cell, False)
            for i in check.sample_units(cell.seed, finished,
                                        spec["check_units"]):
                served = outputs[i]
                lp = check.reference_logprobs(ctl, tr.unit(i), served)
                K = spec["num_beams"]
                # in the layout the capture keeps: a row a beam
                captured[i] = dict(
                    prefill=lp[:, 0],
                    step1_tokens=served[:, 0].repeat_interleave(K),
                    step1=lp[:, 1].repeat_interleave(K, dim=0),
                    first=lp[:, :served.shape[1]].argmax(dim=-1))
    del ctl
    gc.collect()
    if str(cell.device).startswith("cuda"):
        torch.cuda.empty_cache()
