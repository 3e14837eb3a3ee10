"""Param groups, freezing, schedules and AdamW (counterpart of
`mm_interleaved_tpu/engine/optim.py`).

Trainability and groups are decided on the JAX path of every parameter:
the port's module tree is walked and each name mapped back to the path the
JAX package gives the same leaf (`utils.from_flax.param_jax_paths`), so the
JAX regexes apply unchanged, to the real tree and never to a list of names.

`AdamW` computes what the JAX package's
``clip_by_global_norm -> multi_transform(scale_by_adam ->
add_decayed_weights -> scale_by_schedule)`` computes, per group with the
group's lr scale and weight decay, and `set_to_zero` for frozen leaves:
optax's clip rule (``g * max_norm / norm`` where ``norm >= max_norm``),
bias-corrected moments, and a schedule read at the count before its
increment.  The global norm runs over the trainable leaves: the JAX
trainer's includes the gradients of the frozen leaves, which the port does
not compute (13.4 B of them in the flagship).

Masters: the optimizer keeps fp32 masters of the trainable parameters
(the parameter itself where it is fp32) and the fp32 moments; after each
update the model's parameters take the masters' values in their own dtype
(bf16 compute weights on the card, as flax casts fp32 params to its compute
dtype at each use).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils.from_flax import param_jax_paths

# (first match wins) reference defaults: mm_pretrain.yaml:14-21
DEFAULT_PARAM_GROUPS: Tuple[Tuple[str, float, Optional[float]], ...] = (
    # (substring-regex, lr scale vs base, weight decay override)
    (r"llama_cross_attn/gate", 1.0, 0.0),
    (r"sampling_offsets", 0.1, 0.0),
    (r"llama_cross_attn", 1.0, None),
    (r"image_decoder/unet", 0.1, None),
)

DEFAULT_FROZEN_PATTERNS: Tuple[str, ...] = (
    # CLIP ViT core
    r"visual_tokenizer/encoder/(embeddings|pre_layrnorm|layers_\d+)/",
    # LLM minus cross-attn
    r"mm_decoder/(?!.*llama_cross_attn)",
    # frozen copied lm_head
    r"text_decoder/head/",
    # VAE
    r"image_decoder/vae/",
    # MMFS ignore token
    r".*/ignore_token$",
)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.995
    eps: float = 1e-6
    grad_clip: float = 1.0
    warmup_steps: int = 1000
    total_steps: int = 15000
    schedule: str = "cosine"  # or "constant"
    min_lr_ratio: float = 0.0
    param_groups: Tuple[Tuple[str, float, Optional[float]], ...] = (
        DEFAULT_PARAM_GROUPS
    )
    frozen_patterns: Tuple[str, ...] = DEFAULT_FROZEN_PATTERNS
    freeze: bool = True


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """optax's ``warmup_constant_schedule(0, lr, warmup)`` or
    ``warmup_cosine_decay_schedule(0, lr, warmup, total, lr * min_ratio)``
    as a function of the update count.  As in optax, the constant schedule
    is one linear ramp, which holds its initial value 0 when ``warmup <=
    0``."""
    lr, warm = cfg.learning_rate, cfg.warmup_steps

    def warmup(count: int) -> float:
        if warm <= 0:
            return 0.0
        return lr * min(max(count, 0), warm) / warm

    if cfg.schedule == "constant":
        return warmup
    decay = cfg.total_steps - warm
    if decay <= 0:
        raise ValueError(f"total_steps {cfg.total_steps} <= warmup {warm}")
    alpha = 0.0 if lr == 0.0 else cfg.min_lr_ratio

    def cosine(count: int) -> float:
        c = min(count, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay))
                     + alpha)

    return lambda count: warmup(count) if count < warm else cosine(count - warm)


def label_for_path(path: str, cfg: OptimConfig) -> str:
    if cfg.freeze:
        for pat in cfg.frozen_patterns:
            if re.search(pat, path):
                return "frozen"
    for i, (pat, _, _) in enumerate(cfg.param_groups):
        if re.search(pat, path):
            return f"group_{i}"
    return "default"


def param_labels(model: nn.Module, cfg: OptimConfig) -> Dict[str, str]:
    """Parameter name -> ``"frozen"``, ``"default"`` or ``"group_{i}"``."""
    return {name: label_for_path(path, cfg)
            for name, path in param_jax_paths(model).items()}


def freeze(model: nn.Module, cfg: OptimConfig) -> Dict[str, str]:
    """Set ``requires_grad`` from the labels; returns them."""
    labels = param_labels(model, cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] != "frozen")
    return labels


class AdamW:
    """AdamW over ``(name, param, label)`` of the trainable leaves, with
    fp32 masters and moments (see the module docstring)."""

    def __init__(self, named: List[Tuple[str, nn.Parameter, str]],
                 cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.names = [n for n, _, _ in named]
        self.params = [p for _, p, _ in named]
        self.labels = [lab for _, _, lab in named]
        groups = {"default": (1.0, None)}
        for i, (_, scale, wd) in enumerate(cfg.param_groups):
            groups[f"group_{i}"] = (scale, wd)
        self.group_of = [groups[lab] for lab in self.labels]
        self.masters = [p.data if p.dtype == torch.float32
                        else p.detach().float().clone() for p in self.params]
        self.m = [torch.zeros_like(x) for x in self.masters]
        self.v = [torch.zeros_like(x) for x in self.masters]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], grad_norm: torch.Tensor):
        """One update from the fp32 ``grads`` (in parameter order; clipped
        in place) and their global norm."""
        c = self.cfg
        if c.grad_clip > 0:
            clip = torch.where(grad_norm < c.grad_clip,
                               torch.ones_like(grad_norm),
                               c.grad_clip / grad_norm)
            for g in grads:
                g.mul_(clip)
        lr = self.schedule(self.count)  # read before the count advances
        t = self.count + 1
        bc1, bc2 = 1.0 - c.beta1 ** t, 1.0 - c.beta2 ** t
        for i, g in enumerate(grads):
            scale, wd = self.group_of[i]
            m, v, x = self.m[i], self.v[i], self.masters[i]
            m.mul_(c.beta1).add_(g, alpha=1.0 - c.beta1)
            v.mul_(c.beta2).addcmul_(g, g, value=1.0 - c.beta2)
            u = (m / bc1) / ((v / bc2).sqrt_() + c.eps)
            u.add_(x, alpha=c.weight_decay if wd is None else wd)
            x.add_(u, alpha=-lr * scale)
            if x is not self.params[i].data:
                self.params[i].data.copy_(x)
        self.count = t

    def state_dict(self) -> dict:
        return dict(count=self.count,
                    m=dict(zip(self.names, self.m)),
                    v=dict(zip(self.names, self.v)))

    @torch.no_grad()
    def load_state_dict(self, state: dict, masters: Dict[str, torch.Tensor]):
        self.count = int(state["count"])
        for i, n in enumerate(self.names):
            self.m[i].copy_(state["m"][n])
            self.v[i].copy_(state["v"][n])
            self.masters[i].copy_(masters[n])
            if self.masters[i] is not self.params[i].data:
                self.params[i].data.copy_(self.masters[i])
