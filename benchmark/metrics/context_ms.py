"""Device milliseconds a call of `generate_image_inputs` (the images
encoded, the cache-free prefix forward, the context windows), per unit:
the CUDA-event span ``context`` summed over the window, over its count."""


def read(readings: dict, split: str):
    total, n = readings.get("spans", {}).get("context", (0.0, 0))
    return total / n if n else None
