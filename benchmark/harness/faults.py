"""Faults planted under the timed path, for the tests that show the check
catches them: the program's runtime, made as usual, with an answer
altered where it is produced."""

from __future__ import annotations

from . import models


def program(fault):
    """A maker of the runtime (`runner.run`'s ``program``) that plants
    ``fault(gen)``."""
    def make(config, seed, device):
        gen = models.program(config, seed, device)
        fault(gen)
        return gen
    return make


def alter_token(gen):
    """The first served token of the first request of every unit
    replaced by another ordinary token."""
    orig = gen.generate_texts

    def generate_texts(*a, **k):
        out = orig(*a, **k).clone()
        out[0, 0] = (out[0, 0] + 7) % 100 + 10
        return out

    gen.generate_texts = generate_texts


def alter_image(gen):
    """A 4 x 4 corner of every image inverted."""
    orig = gen.denoise

    def denoise(*a, **k):
        out = orig(*a, **k).clone()
        out[:, :4, :4] = 1.0 - out[:, :4, :4]
        return out

    gen.denoise = denoise


def skew_prefill(gen):
    """Every other row's prefill logits 5% off."""
    model = gen.model
    orig = model.lm_prefill

    def lm_prefill(*a, **k):
        logits, *rest = orig(*a, **k)
        logits = logits.clone()
        logits[1::2] *= 1.05
        return (logits, *rest)

    model.lm_prefill = lm_prefill
