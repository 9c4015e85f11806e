"""Device idle share of the traced training window: 1 - the union of the
kernels' intervals / the window, in %."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
