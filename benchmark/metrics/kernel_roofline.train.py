"""Least time of the training steps' products and attention cores, forward
and backward, in the traced window / the kernels' busy time, in %."""

from benchmark import readers


def read(run):
    return readers.kernel_roofline(run)
