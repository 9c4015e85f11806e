"""The harness's spans and the traced window.

``Recorder.span(name)`` times a call into the program on the host clock and,
in a traced run, also marks it as a ``torch.profiler.record_function``
range (``bench:<name>``), so the trace can say what the host was doing while
the device sat idle. ``Window`` runs the profiler (CPU and CUDA) around the
measured window and reduces its events:

- busy time: the union of the kernels' intervals inside the window
  (overlapping streams counted once); copies and sets are not kernels;
- copy time: the union of the copies' and sets' intervals, apart;
- kernel launches: the kernels that ran inside the window;
- ``device_ops``: device seconds by operation name (kernels, copies and
  sets), the largest first;
- ``idle_gaps``: the seconds in which the device ran no kernel, by the
  innermost harness span the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import gc
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import card

COPY_ACTIVITIES = ("gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"
TOP = 10
NEST = 4  # harness spans nest no deeper: the search for a gap's span looks this far back


class Recorder:
    """Host seconds and counts of the harness's spans, by name."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            if self.traced:
                with torch.profiler.record_function(SPAN_PREFIX + name):
                    yield
            else:
                yield
        finally:
            self.seconds[name] += time.perf_counter() - t
            self.counts[name] += 1


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> Tuple[float, List[Tuple[int, int]]]:
    """(seconds covered, the merged intervals) of ``[start_ns, end_ns)``
    intervals."""
    merged: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged) / 1e9, merged


def idle_by_span(merged: Sequence[Tuple[int, int]], lo: int, hi: int,
                 spans: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds of ``[lo, hi)`` outside the merged busy intervals, by the
    innermost span (of properly nested ones: the latest started) that holds
    each gap's middle, ``"none"`` where none does."""
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    by_start = sorted(spans)
    starts = [s for s, _, _ in by_start]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid, name = (g0 + g1) // 2, "none"
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - NEST, -1), -1):
            if by_start[i][1] >= mid:
                name = by_start[i][2]
                break
        out[name] += (g1 - g0) / 1e9
    return dict(out)


def settle_host() -> None:
    """The last step of set-up: collect set-up's garbage and move what
    survives out of the collector's reach (``gc.freeze``), so that the
    window's full collections walk only what the window made. Without it the
    first full collections after set-up walk the model's and the
    tokenizer's objects, 100-170 ms each, several a window, pauses a process
    pays once and a 30 s window would weigh as steady. ``Window.stop``
    undoes it."""
    gc.collect()
    gc.freeze()


class Window:
    """The measured window: its host bounds, and in a traced run the
    profiler and its reduction (``summary``)."""

    def __init__(self, traced: bool, device):
        self.traced, self.device = traced, device
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
        card.sync(self.device)
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        card.sync(self.device)
        self.t1_ns = time.time_ns()
        gc.unfreeze()
        if self.prof is not None:
            self.prof.stop()
            self.summary = reduce_events(self.prof.profiler.kineto_results.events(),
                                         self.t0_ns, self.t1_ns)
            self.prof = None

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def activity(e) -> str:
    """The kineto activity of a profiler event: ``"kernel"``, ``"gpu_memcpy"``,
    ``"gpu_memset"``, ``"user_annotation"`` (a ``record_function`` range on
    the host), or another name. Read from the event's own field where the
    installed PyTorch has it, else from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    on_device = str(e.device_type()).endswith("CUDA")
    if e.name().startswith(SPAN_PREFIX) or e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def reduce_events(events, lo: int, hi: int) -> Dict:
    """busy_s, copy_s, window_s, kernels, device_ops and idle_gaps of the
    profiler's events inside ``[lo, hi)`` (epoch ns, the profiler's clock)."""
    intervals, copies, spans = [], [], []
    by_name: Dict[str, float] = defaultdict(float)
    kernels = 0
    for e in events:
        kind = activity(e)
        if kind == "kernel" or kind in COPY_ACTIVITIES:
            start = e.start_ns()
            s, t = max(start, lo), min(start + e.duration_ns(), hi)
            if t <= s:
                continue
            (intervals if kind == "kernel" else copies).append((s, t))
            by_name[e.name()] += (t - s) / 1e9
            kernels += kind == "kernel"
        elif kind == "user_annotation" and e.name().startswith(SPAN_PREFIX):
            start = e.start_ns()
            spans.append((start, start + e.duration_ns(), e.name()[len(SPAN_PREFIX):]))
    busy, merged = union_seconds(intervals)
    idle = idle_by_span(merged, lo, hi, spans)
    return {
        "busy_s": busy,
        "copy_s": union_seconds(copies)[0],
        "window_s": (hi - lo) / 1e9,
        "kernels": kernels,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }
