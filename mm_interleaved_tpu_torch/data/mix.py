"""Probability-weighted dataset mixing.

Re-design of the reference `custom_datasets/mix_dataset.py:13-141`
(`random_samples` / `RandomMixWdsDataset`): round-robin draw of the next
source by normalised probability, per-host seeding, and the three exhaustion
policies — ``sum`` (drop exhausted sources), ``longest`` (restart exhausted
sources until every source finished once), ``shortest`` (stop at the first
exhaustion).

The port's copy of `mm_interleaved_tpu/data/mix.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


class RandomMixIterable:
    def __init__(
        self,
        dataset_factories: Sequence[Callable[[int], Iterator]],
        probs: Optional[Sequence[float]] = None,
        sampling_type: str = "sum",
        seed: int = 0,
    ):
        assert sampling_type in ("sum", "longest", "shortest")
        self.factories = list(dataset_factories)
        p = np.asarray(
            probs if probs is not None else [1.0] * len(self.factories),
            dtype=np.float64,
        )
        self.probs = p / p.sum()
        self.sampling_type = sampling_type
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator:
        rng = np.random.RandomState(self.seed + self.epoch)
        iters: List[Optional[Iterator]] = [
            iter(f(self.epoch)) for f in self.factories
        ]
        finished_once = [False] * len(iters)
        probs = self.probs.copy()
        while True:
            alive = [i for i in range(len(iters)) if iters[i] is not None]
            if not alive:
                return
            p = probs[alive] / probs[alive].sum()
            idx = int(rng.choice(alive, p=p))
            try:
                yield next(iters[idx])
            except StopIteration:
                finished_once[idx] = True
                if self.sampling_type == "shortest":
                    return
                if self.sampling_type == "sum":
                    iters[idx] = None
                else:  # longest: restart until all have finished once
                    if all(finished_once):
                        return
                    iters[idx] = iter(self.factories[idx](self.epoch + 1))
