"""The arithmetic of the end-to-end numbers: rates over the whole window
and tails over every request, never medians of chunks."""

from __future__ import annotations

import math
from typing import Sequence


def rate(count: float, seconds: float) -> float:
    """Work completed over the time it took."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
