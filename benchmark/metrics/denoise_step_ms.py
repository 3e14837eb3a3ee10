"""Device milliseconds a call of the UNet forward (one call: both CFG
halves of every row): the CUDA-event span ``unet`` summed over the
window, over its count."""


def read(readings: dict, split: str):
    total, n = readings.get("spans", {}).get("unet", (0.0, 0))
    return total / n if n else None
