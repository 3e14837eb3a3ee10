"""Device milliseconds a call of `lm_prefill`, per unit: the CUDA-event
span ``prefill`` summed over the window, over its count."""


def read(readings: dict, split: str):
    total, n = readings.get("spans", {}).get("prefill", (0.0, 0))
    return total / n if n else None
