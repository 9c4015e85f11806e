"""What the per-layer readers of ``benchmark/metrics`` read, and the
arithmetic they share.

Each file ``benchmark/metrics/<metric>.py`` defines ``read(run) -> float or
None`` for the metric of that name in ``BENCHMARK.json``; ``None`` means the
run holds nothing for it to read, and the metric is left out of the line.
A share of a peak or of a roofline is never made up as 0. The readers know
no kind of traffic: each loop hands over the counted work of its window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Mapping, Optional

from . import counts

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclasses.dataclass
class Run:
    """One run of a cell, as the readers see it."""

    cfg: Mapping                  # the configuration's file
    dtype: str                    # the compute dtype's name
    trace: Optional[Dict]         # trace.reduce_events of the traced window
    span_seconds: Mapping[str, float]
    works: List[counts.Work]      # counted operations and bytes of the window's work
    items: int                    # images or pairs completed in the window
    steps: int                    # requests or training steps completed in the window
    memory_peak_bytes: int
    peaks: Optional[Mapping]      # the card's row of peaks.json


def load_reader(name: str):
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def idle_share(run: Run) -> Optional[float]:
    """1 - the union of the kernels' intervals / the traced window, in %."""
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu(run: Run) -> Optional[float]:
    """The window's counted operations over its length at the dtype's peak."""
    if not run.trace or not run.peaks or not run.works:
        return None
    return 100.0 * counts.total_ops(run.works) / run.trace["window_s"] / run.peaks[run.dtype]


def kernel_roofline(run: Run) -> Optional[float]:
    """The least time of the window's products and cores over the kernels'
    busy time."""
    if not run.trace or not run.peaks or not run.works or run.trace["busy_s"] <= 0:
        return None
    least = counts.least_seconds(run.works, run.peaks[run.dtype], run.peaks["bytes_per_s"])
    return 100.0 * least / run.trace["busy_s"]


def launches_per(run: Run, per_item: bool) -> Optional[float]:
    """Kernels in the traced window per image or pair (``per_item``) or per
    step."""
    n = run.items if per_item else run.steps
    if not run.trace or n <= 0:
        return None
    return run.trace["kernels"] / n


def span_ms_per_step(run: Run, span: str) -> Optional[float]:
    """Milliseconds of a harness span over the window, per step."""
    if run.steps <= 0 or span not in run.span_seconds:
        return None
    return 1000.0 * run.span_seconds[span] / run.steps


def copy_us_per_item(run: Run) -> Optional[float]:
    """Device microseconds of copies and sets in the traced window per image
    or pair."""
    if not run.trace or run.items <= 0:
        return None
    return 1e6 * run.trace["copy_s"] / run.items
