"""The whole step's share of the card's bf16 peak: the model FLOPs of
every unit in the window (`benchmark.yardstick.flops`: the plain model at
the unit's shapes, no recompute) over the window's seconds, over 989
TFLOP/s."""

from benchmark.yardstick.peaks import PEAK_BF16_FLOPS


def read(readings: dict, split: str):
    flops = readings.get("unit_flops")
    if not flops:
        return None
    return 100.0 * flops * readings["units"] / (
        readings["window_s"] * PEAK_BF16_FLOPS)
