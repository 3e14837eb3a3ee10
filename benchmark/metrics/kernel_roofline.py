"""The program's own CUDA kernels against their bounds in the profiled
units: the sum of each call's bound time (`benchmark.yardstick.work`:
max(bytes / 3.35 TB/s, operations / the peak of their type) at the
call's shapes) over the sum of the kernels' device time (the profiler's
kernels inside each call's range)."""

KERNELS = None  # every kernel the work table counts


def share(readings: dict, kernels=None):
    bounds = readings.get("kernel_bounds_s") or {}
    device = (readings.get("profile") or {}).get("kernel_device_s") or {}
    names = [k for k in bounds if k in device and device[k] > 0
             and (kernels is None or k in kernels)]
    dev = sum(device[k] for k in names)
    if not names or dev <= 0:
        return None
    return 100.0 * sum(bounds[k] for k in names) / dev


def read(readings: dict, split: str):
    return share(readings, KERNELS)
