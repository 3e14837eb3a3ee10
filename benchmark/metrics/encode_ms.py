"""Device milliseconds a call of `prepare_mm_embeds` (the images encoded,
the prompt embedded), per unit: the CUDA-event span ``encode`` summed
over the window, over its count."""


def read(readings: dict, split: str):
    total, n = readings.get("spans", {}).get("encode", (0.0, 0))
    return total / n if n else None
