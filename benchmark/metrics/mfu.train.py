"""Operations of the training steps completed in the traced window (both
towers' forward and backward and the logits: 3x the forward, no
recomputation) / the window / the dtype's dense peak, in %."""

from benchmark import readers


def read(run):
    return readers.mfu(run)
