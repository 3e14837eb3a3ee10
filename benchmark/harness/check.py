"""What decides ``correct``: the timed path's own outputs, on a sample of
the window's finished units drawn from the seed, against the plain
reference (`benchmark.reference`, float32, the same weights worked out
again from the seed).  Each number compared is printed beside its limit
(``benchmark/limits/<cell>.json``).

* ``generate_images``: the images of two requests of one finished unit
  (the one with the most context in it, and one more), against the
  reference's, from the same inputs and the same initial latents and
  DDPM noise (drawn again from the unit's noise seed in the program's
  order: the latents, then one draw a step); ``image_rms_gap`` is the
  widest root-mean-square pixel gap (pixels in [0, 1]).
* ``generate_texts``: every request of two finished units.  The
  reference runs once over each prompt with its served tokens (the
  prompt as the prefill sees it, the served tokens as the decode steps
  embed them).  ``logprob_gap``: the widest gap between the program's
  log-probabilities (the prefill's last position and the first decode
  step's row of the served first token, kept from the window) and the
  reference's, over the reference's 32 most likely tokens.
  ``served_rank_gap``: the widest amount by which a served token's
  reference log-probability lies below the reference's ``C``-th best at
  its position, ``C`` the beam search's candidates a step (``2 *
  beams``), every served token up to the first stop."""

from __future__ import annotations

import contextlib
import json
from typing import Dict, List

import numpy as np
import torch

from .spec import BENCH_DIR
from .trace import replace_attr

TOP = 32


@contextlib.contextmanager
def full_fp32():
    """float32 products and convolutions without TF32 while the
    reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def limits(cell_name: str) -> Dict[str, float]:
    return json.loads((BENCH_DIR / "limits" / f"{cell_name}.json")
                      .read_text())["limits"]


class Capture:
    """Keeps, for every unit of the window, the program's prefill logits at
    the last prompt position and its first decode step's inputs and
    logits (`lm_prefill` and `lm_decode_step` wrapped on the instance)."""

    def __init__(self, model):
        self.units: Dict[int, dict] = {}
        self.current = None
        self._undo = []
        cap = self

        prefill = model.lm_prefill
        step = model.lm_decode_step

        def lm_prefill(*a, **k):
            out = prefill(*a, **k)
            if cap.current is not None:
                cap.current["prefill"] = out[0][:, -1].detach().clone()
            return out

        def lm_decode_step(token_ids, *a, **k):
            out = step(token_ids, *a, **k)
            cur = cap.current
            if cur is not None and "step1" not in cur:
                cur["step1_tokens"] = token_ids[:, 0].detach().clone()
                cur["step1"] = out[0][:, 0].detach().clone()
            return out

        self._undo.append(replace_attr(model, "lm_prefill", lm_prefill))
        self._undo.append(replace_attr(model, "lm_decode_step",
                                       lm_decode_step))

    def start(self, i: int) -> None:
        self.current = self.units[i] = {}

    def stop(self) -> None:
        self.current = None

    def remove(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo = []

    def to_host(self) -> None:
        for u in self.units.values():
            for k in list(u):
                u[k] = u[k].cpu()


def sample_units(seed: int, finished: List[int], n: int) -> List[int]:
    rng = np.random.RandomState(seed % (1 << 32))
    n = min(n, len(finished))
    return sorted(int(x) for x in rng.choice(finished, size=n,
                                             replace=False))


# ---------------------------------------------------------------- images


def image_rows(seed: int, unit: dict, n: int) -> List[int]:
    """The request with the most context (tokens and images), then ``n -
    1`` more drawn from the seed."""
    ctx = (unit["attention_mask"].sum(dim=1)
           + 1000 * unit["num_image_per_seq"]).cpu().numpy()
    first = int(np.argmax(ctx))
    rest = [b for b in range(len(ctx)) if b != first]
    rng = np.random.RandomState((seed + 1) % (1 << 32))
    return [first] + [int(b) for b in rng.choice(rest, size=n - 1,
                                                 replace=False)]


@torch.no_grad()
def reference_images(ref, traffic, i: int, rows: List[int]) -> torch.Tensor:
    from ..reference.generation.diffusion import draw_noise, generate_images

    spec = traffic.spec
    u = traffic.unit(i)
    r = torch.tensor(rows, device=u["text_ids"].device)
    inp = ref.generate_image_inputs(
        u["text_ids"][r], u["image_tensors"][r],
        u["num_image_per_seq"][r], u["attention_mask"][r])
    tgt = (torch.arange(len(rows), device=r.device) * traffic.slots
           + u["num_image_per_seq"][r] - 1)
    g = torch.Generator(device=u["text_ids"].device)
    g.manual_seed(traffic.noise_seed(i))
    lat, noi = draw_noise(ref, traffic.batch_size,
                          spec["num_inference_steps"], spec["sampler"], g,
                          u["text_ids"].device)
    return generate_images(
        ref, *(x[tgt] for x in inp),
        num_inference_steps=spec["num_inference_steps"],
        guidance_scale=spec["guidance_scale"], sampler=spec["sampler"],
        latents=lat[r], noises=None if noi is None else noi[:, r]).cpu()


def image_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.float() - want.float()).reshape(got.shape[0], -1)
    return float(d.square().mean(dim=1).sqrt().max())


# ---------------------------------------------------------------- texts


@torch.no_grad()
def reference_logprobs(ref, unit: dict, served: torch.Tensor) -> torch.Tensor:
    """The reference's log-probabilities ``[B, T + 1, V]`` after the
    prompt and after each served token: one cache-free pass over the
    prompt (as `prepare_mm_embeds` makes it) and the served tokens (as a
    decode step embeds them, seeing the images the last prompt position
    sees)."""
    from ..reference.models import stream_ops as so

    c = ref.cfg
    ids, att = unit["text_ids"], unit["attention_mask"]
    dev = ids.device
    served = served.to(dev)
    prep = ref.prepare_mm_embeds(ids, unit["image_tensors"],
                                 unit["num_image_per_seq"])
    new = ref.mm_decoder.embed(served)
    new = so.add_soi_embeds(new, served, ref.soi_token.to(new.dtype),
                            c.special.soi_token_id)
    T = served.shape[1]
    embeds = torch.cat([prep["mm_embeds"], new], dim=1)
    mask = torch.cat([att, torch.ones_like(served, dtype=att.dtype)], dim=1)
    xmask = prep["cross_attention_mask"]
    xmask = torch.cat([xmask, xmask[:, -1:].expand(-1, T, -1)], dim=1)
    hidden, _, _ = ref.mm_decoder(
        embeds, attention_mask=mask, vision_hidden_states=prep["mmfs_values"],
        cross_attention_mask=xmask)
    L = ids.shape[1]
    logits = ref.text_decoder(hidden[:, L - 1:L + T])
    return torch.log_softmax(logits.float(), dim=-1).cpu()


def served_length(tokens: torch.Tensor, eos_ids) -> List[int]:
    """Each row's served tokens up to and including the first stop."""
    out = []
    for row in tokens.tolist():
        n = len(row)
        for t, x in enumerate(row):
            if x in eos_ids:
                n = t + 1
                break
        out.append(n)
    return out


def logprob_gap(ref_lp: torch.Tensor, prog_logits: torch.Tensor) -> float:
    """The widest gap, over the reference's ``TOP`` most likely tokens, of
    the program's log-probabilities from the reference's (rows paired)."""
    prog = torch.log_softmax(prog_logits.float(), dim=-1)
    top = ref_lp.topk(TOP, dim=-1).indices
    return float((prog.gather(-1, top) - ref_lp.gather(-1, top)).abs().max())


def text_gaps(ref_lp: torch.Tensor, served: torch.Tensor, captured: dict,
              beams: int, eos_ids) -> Dict[str, float]:
    """``logprob_gap`` and ``served_rank_gap`` of one unit (the rank of
    the served tokens, or, where ``captured`` holds a control's ``first``
    tokens at the same positions, of those)."""
    B = served.shape[0]
    lens = served_length(served, eos_ids)
    C = max(2, 1 + len(eos_ids)) * beams
    scored = captured.get("first", served)
    rank_gap = 0.0
    for b in range(B):
        for t in range(lens[b]):
            lp = ref_lp[b, t]
            cth = lp.topk(C).values[-1]
            rank_gap = max(rank_gap, float(cth - lp[scored[b, t]]))
    gaps = [logprob_gap(ref_lp[:, 0], captured["prefill"])]
    if "step1" in captured:
        rows = []
        for b in range(B):
            if lens[b] < 2:
                continue
            cands = [r for r in range(b * beams, (b + 1) * beams)
                     if int(captured["step1_tokens"][r]) == int(served[b, 0])]
            if cands:
                rows.append((b, cands[0]))
        if rows:
            bs = torch.tensor([b for b, _ in rows])
            rs = torch.tensor([r for _, r in rows])
            gaps.append(logprob_gap(ref_lp[bs, 1], captured["step1"][rs]))
    return dict(logprob_gap=max(gaps), served_rank_gap=rank_gap)
