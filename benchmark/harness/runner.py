"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

The window is a closed loop of whole units (a batch of requests through
the cell's entry, its outputs copied to the host), each started when the
last returns, until ``seconds`` have passed since the first started.
Every rate is over all the units and all the time from the first unit's
start to the last one's end; a request's latency is the time from its
unit's start to its outputs' return."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from . import check, models, spec as specs
from .traffic import Traffic

# the spans of each entry: (the object's path from the runtime, the bound
# method wrapped on it, the span's name, whether it is timed); the untimed
# ones only name what the host was doing in the profiled units
SPANS = {
    "generate_images": [
        ("", "denoise", "denoise", False),
        ("model", "generate_image_inputs", "context", True),
        ("model.image_decoder", "unet_pred", "unet", True),
        ("model.image_decoder", "vae_decode", "vae_decode", False),
    ],
    "generate_texts": [
        ("", "generate_texts", "generate_texts", False),
        ("model", "prepare_mm_embeds", "encode", True),
        ("model", "lm_prefill", "prefill", True),
        ("model", "lm_decode_step", "decode_step", True),
    ],
}


def install_spans(gen, entry: str, timed: bool):
    from .trace import Spans

    spans = Spans()
    for path, attr, name, t in SPANS[entry]:
        spans.wrap(_attr(gen, path), attr, name, t and timed)
    return spans


def _text_config(spec: dict):
    from mm_interleaved_tpu_torch.generation.text import TextGenerationConfig

    return TextGenerationConfig(
        max_new_tokens=spec["max_new_tokens"],
        min_new_tokens=spec["min_new_tokens"], num_beams=spec["num_beams"],
        length_penalty=spec["length_penalty"])


def run_unit(gen, traffic: Traffic, i: int, text_cfg=None):
    """Unit ``i`` through the runtime ``gen``; returns its outputs on the
    host (images ``[B, H, W, 3]`` or new tokens ``[B, T]``)."""
    u = traffic.unit(i)
    spec = traffic.spec
    if traffic.entry == "generate_images":
        inp = gen.generate_image_inputs(u["text_ids"], u["image_tensors"],
                                        u["num_image_per_seq"],
                                        u["attention_mask"])
        rows = u["target_rows"]
        g = torch.Generator(device=u["text_ids"].device)
        g.manual_seed(traffic.noise_seed(i))
        out = gen.denoise(*(x[rows] for x in inp), g,
                          num_inference_steps=spec["num_inference_steps"],
                          guidance_scale=spec["guidance_scale"],
                          sampler=spec["sampler"])
    else:
        out = gen.generate_texts(u["text_ids"], u["image_tensors"],
                                 u["num_image_per_seq"], u["attention_mask"],
                                 cfg=text_cfg)
    return out.cpu()


def _attr(obj, path: str):
    for p in filter(None, path.split(".")):
        obj = getattr(obj, p)
    return obj


class Cell:
    """A cell's configuration, traffic and runtime on ``device``."""

    def __init__(self, cell_name: str, seed: int, device,
                 program: Optional[Callable] = None):
        self.cell = specs.cell(cell_name)
        self.name = cell_name
        self.seed = int(seed)
        self.device = device
        self.config = specs.config_spec(self.cell["config"])
        self.traffic = Traffic(specs.traffic_spec(self.cell["traffic"]),
                               self.config["model"], seed, device)
        self.make_program = program or models.program
        self.text_cfg = (_text_config(self.traffic.spec)
                         if self.traffic.entry == "generate_texts" else None)

    def unit(self, gen, i: int):
        return run_unit(gen, self.traffic, i, self.text_cfg)


def window(cell: Cell, gen, seconds: float, capture=None) -> dict:
    """Whole units from index 0 until ``seconds`` have passed; returns the
    units' indices, start and end times, and outputs."""
    units, starts, ends, outs = [], [], [], {}
    if str(cell.device).startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while True:
        s = time.perf_counter()
        if capture is not None:
            capture.start(i)
        outs[i] = cell.unit(gen, i)
        if capture is not None:
            capture.stop()
        e = time.perf_counter()
        units.append(i)
        starts.append(s)
        ends.append(e)
        i += 1
        if e - t0 >= seconds:
            break
    return dict(units=units, starts=starts, ends=ends, outputs=outs)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None,
        program: Optional[Callable] = None,
        control: Optional[Callable] = None, log=print) -> dict:
    """One run; returns the result dict (its ``checks`` list holds each
    number compared with its limit).  ``program(config, seed, device)``
    replaces the runtime's maker (the tests' faults);
    ``control(cell, finished, outputs, captured)`` puts a control's
    outputs in the program's place before the check
    (`harness.controls.apply`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(cell_name, seed, device, program)
    tr = cell.traffic
    spec = tr.spec
    gen = cell.make_program(cell.config, seed, device)
    model = gen.model
    on_card = str(device).startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for w in range(spec.get("warmup_units", 1)):
        cell.unit(gen, -1 - w)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s")

    capture = check.Capture(model) if tr.entry == "generate_texts" else None
    spans = install_spans(gen, tr.entry, True) if trace else None
    win = window(cell, gen, seconds, capture=capture)
    result = dict(setup_s=setup_s)
    n_req = tr.batch_size
    elapsed = win["ends"][-1] - win["starts"][0]
    latencies = [e - s for s, e in zip(win["starts"], win["ends"])
                 for _ in range(n_req)]
    result.update(units=len(win["units"]), requests=n_req * len(win["units"]),
                  window_s=elapsed, latencies_s=latencies)
    unit_s = sorted(e - s for s, e in zip(win["starts"], win["ends"]))
    log(f"window {elapsed:.3f} s, {len(win['units'])} units, "
        f"{len(latencies)} requests; a unit {unit_s[0]:.4f} s to "
        f"{unit_s[-1]:.4f} s, median {unit_s[len(unit_s) // 2]:.4f} s")
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if on_card else 0)
    if spans is not None:
        result["spans"] = spans.totals()
        spans.remove()
        result["profile_units"] = spec.get("profile_units", 1)
        result["profile"], result["kernel_bounds_s"] = _profile(
            cell, gen, win["units"][-1] + 1, result["profile_units"])
    if capture is not None:
        capture.remove()
        capture.to_host()
    outputs = win["outputs"]
    captured = capture.units if capture else None
    del gen, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if control is not None:
        control(cell, win["units"], outputs, captured)
    if trace:
        from ..yardstick.flops import unit_flops

        result["unit_flops"] = unit_flops(
            models.reference_config(cell.config,
                                    tr.entry == "generate_images"),
            tr, tr.unit(0))
    t_check = time.perf_counter()
    result["checks"] = compare(cell, win["units"], outputs, captured, log)
    log(f"checked in {time.perf_counter() - t_check:.1f} s")
    return result


def _profile(cell: Cell, gen, first: int, n: int):
    """A `torch.profiler` trace over ``n`` whole units after the window,
    with the program's kernels wrapped."""
    from .trace import KernelCalls, PREFIX, profiled, read_profile

    calls = KernelCalls()
    calls.install()
    labels = install_spans(gen, cell.traffic.entry, False)
    try:
        torch.cuda.synchronize()
        with profiled() as prof:
            for i in range(first, first + n):
                with torch.profiler.record_function(PREFIX + "unit"):
                    cell.unit(gen, i)
            torch.cuda.synchronize()
    finally:
        labels.remove()
        calls.remove()
    return read_profile(prof), calls.bounds_s()


def compare(cell: Cell, finished: List[int], outputs: Dict[int, torch.Tensor],
            captured, log=print) -> List[dict]:
    """The numbers that decide ``correct``, each with its limit."""
    tr = cell.traffic
    spec = tr.spec
    lim = check.limits(cell.name)
    with check.full_fp32():
        readings = _readings(cell, finished, outputs, captured, log)
    return [dict(name=k, value=v, limit=lim[k]) for k, v in readings.items()]


def _readings(cell: Cell, finished, outputs, captured, log):
    tr = cell.traffic
    spec = tr.spec
    ref = models.reference(cell.config, cell.seed, cell.device,
                           image_decoder=tr.entry == "generate_images")
    readings: Dict[str, float] = {}
    if tr.entry == "generate_images":
        (i,) = check.sample_units(cell.seed, finished, 1)
        u = tr.unit(i)
        rows = check.image_rows(cell.seed, u, spec["check_images"])
        want = check.reference_images(ref, tr, i, rows)
        got = outputs[i][rows]
        readings["image_rms_gap"] = check.image_gap(got, want)
        clipped = float(((want <= 0) | (want >= 1)).float().mean())
        log(f"checked unit {i} rows {rows}: reference pixels mean "
            f"{float(want.mean()):.4f} std {float(want.std()):.4f}, "
            f"{clipped:.4f} of them at 0 or 1")
    else:
        eos = tuple(_text_config(spec).eos_token_ids)
        gaps = []
        for i in check.sample_units(cell.seed, finished,
                                    spec["check_units"]):
            lp = check.reference_logprobs(ref, tr.unit(i), outputs[i])
            gaps.append(check.text_gaps(lp, outputs[i], captured[i],
                                        spec["num_beams"], eos))
            log(f"checked unit {i}: {gaps[-1]}")
        readings = {k: max(g[k] for g in gaps) for k in gaps[0]}
    del ref
    gc.collect()
    return readings
