"""Kernels launched in the traced window per image encoded."""

from benchmark import readers


def read(run):
    return readers.launches_per(run, per_item=True)
