"""The device's idle share: 1 - (the device's busy seconds a unit, the
union of every CUDA kernel's interval over the profiled units, per unit)
/ (the seconds a unit took in the measured window, where no profiler
ran).  The profiler's own host cost (tens of microseconds for each of
the tens of thousands of operations a unit launches) lengthens the
profiled units' wall, so the profiled wall would overstate the idle
share of a host-bound path; the device's busy time it records does not
grow with it."""


def read(readings: dict, split: str):
    prof = readings.get("profile") or {}
    units = readings.get("profile_units")
    if not prof.get("busy_s") or not units or not readings.get("units"):
        return None
    unit_s = readings["window_s"] / readings["units"]
    return 100.0 * (1.0 - prof["busy_s"] / units / unit_s)
