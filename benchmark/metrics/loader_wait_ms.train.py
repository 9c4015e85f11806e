"""Milliseconds a training step waits in the harness's span around
``next(loader)``: the span's window total / steps."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_step(run, "loader.next")
