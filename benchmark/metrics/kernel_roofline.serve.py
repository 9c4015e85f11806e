"""Least time of the image tower's products and attention cores in the
traced window (each the longer of its operations at peak and its bytes at
the HBM rate) / the kernels' busy time, in %."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline(run)
