"""Kernel Q, the int8 weight-only projection, against its bound in the
profiled units: the arithmetic of `kernel_roofline`, this kernel alone."""

from benchmark.metrics.kernel_roofline import share


def read(readings: dict, split: str):
    return share(readings, ("int8_linear_cuda",))
