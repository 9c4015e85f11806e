"""Device microseconds of copies and sets (the tiles' host-to-device copy,
the embeddings' way back) in the traced encode window per image."""

from benchmark import readers


def read(run):
    return readers.copy_us_per_item(run)
