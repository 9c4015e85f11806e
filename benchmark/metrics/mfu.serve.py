"""Image-tower forward operations of the images completed in the traced
window / the window / the dtype's dense peak, in %."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
