"""Device milliseconds a call of `lm_decode_step` (one call: every beam
row, one token): the CUDA-event span ``decode_step`` summed over the
window, over its count."""


def read(readings: dict, split: str):
    total, n = readings.get("spans", {}).get("decode_step", (0.0, 0))
    return total / n if n else None
