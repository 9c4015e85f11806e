"""Tracing, profiling and metrics: the port of ``plip_tpu.utils.profiling``.

- ``ThroughputMeter``: rolling items/s and p50/p95 step latency (copied).
- ``trace``: a context manager around ``torch.profiler.profile`` (CPU, and
  CUDA where a card is present) that writes the Chrome trace
  (``*.pt.trace.json.gz``) under ``logdir``; its dict gains
  ``wall_time_s``. A profiler that fails to start raises.
- ``MetricLogger``: a JSONL metric sink (copied).
- ``parse_device_trace``: the device time of a trace, in total and by
  ``torch.profiler.record_function`` range, per step.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # the device's own work
RANGE_CAT = "gpu_user_annotation"  # a record_function range on the device timeline


class ThroughputMeter:
    def __init__(self, window: int = 100):
        self.window = window
        self.times = deque(maxlen=window)
        self.counts = deque(maxlen=window)
        self._last: Optional[float] = None
        self.total_items = 0
        self.total_time = 0.0

    def start(self) -> None:
        self._last = time.perf_counter()

    def step(self, n_items: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            self.counts.append(n_items)
            self.total_time += dt
            self.total_items += n_items
        self._last = now

    @property
    def items_per_sec(self) -> float:
        t = sum(self.times)
        return sum(self.counts) / t if t else 0.0

    def latency_percentile(self, q: float) -> float:
        if not self.times:
            return 0.0
        xs = sorted(self.times)
        idx = min(int(q / 100.0 * len(xs)), len(xs) - 1)
        return xs[idx]

    def summary(self) -> Dict[str, float]:
        return {
            "items_per_sec": self.items_per_sec,
            "p50_latency_s": self.latency_percentile(50),
            "p95_latency_s": self.latency_percentile(95),
            "total_items": self.total_items,
            "total_time_s": self.total_time,
        }


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, name: str = "plip_tpu_torch"):
    """Profile the body with ``torch.profiler`` when ``logdir`` is given.
    Yields a dict that gains, on exit, ``wall_time_s`` (the body's host
    wall, the card synchronized) and with ``logdir`` also ``trace_path``
    (the Chrome trace written there) and ``profiler`` (the finished
    ``torch.profiler.profile``, for its ``events()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    info: Dict = {}
    prof = None
    if logdir:
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=activities)
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        yield info
    finally:
        if cuda:
            torch.cuda.synchronize()
        info["wall_time_s"] = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, f"{name}.{os.getpid()}.{time.time_ns()}"
                                ".pt.trace.json.gz")
            prof.export_chrome_trace(path)
            info["trace_path"], info["profiler"] = path, prof


def parse_device_trace(path: str, n_steps: int = 1, device: int = 0) -> Dict:
    """The device time of a ``torch.profiler`` Chrome trace, per step.

    ``path``: a ``*.pt.trace.json[.gz]`` file, or a directory whose newest
    such file is read. ``n_steps``: how many identical steps the trace
    holds; every time is divided by it. Returns::

        {"step_total_ms": float,   # kernel + memcpy + memset time on CUDA device `device`
         "groups": {range name: {"total_ms": float,
                                 "ops": [(op name, ms), ...]}},
         "outside_ms": float}      # step total - every group's total

    A group is a ``torch.profiler.record_function`` range as the device
    timeline records it (``gpu_user_annotation``): its total is the device
    work that starts inside the range's spans on the same stream (a stream
    runs its work in order), each piece counted once a name. Ranges that nest count their work in each, as
    nested scans do in the JAX package's parser. The work names its device
    in ``args.device``, a range by its ``pid`` (as the H100's traces
    carry them)."""
    import glob
    import gzip
    from collections import Counter

    if os.path.isdir(path):
        cands = glob.glob(os.path.join(path, "*.pt.trace.json*"))
        if not cands:
            raise FileNotFoundError(f"no *.pt.trace.json[.gz] under {path}")
        path = max(cands, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]

    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    work = [e for e in spans
            if e.get("cat") in DEVICE_CATS and e.get("args", {}).get("device") == device]
    ranges = [e for e in spans if e.get("cat") == RANGE_CAT and e.get("pid") == device]
    k = n_steps * 1e3  # over n_steps, us -> ms
    inside: Dict[str, set] = {}
    for r in ranges:
        t0, t1 = r["ts"], r["ts"] + r["dur"]
        hits = inside.setdefault(r["name"], set())
        for i, e in enumerate(work):
            if e["tid"] == r["tid"] and t0 <= e["ts"] < t1:
                hits.add(i)
    groups = {}
    for name, hits in inside.items():
        ops = Counter()
        for i in hits:
            ops[work[i]["name"]] += work[i]["dur"]
        groups[name] = {"total_ms": sum(ops.values()) / k,
                        "ops": [(n, d / k) for n, d in ops.most_common()]}
    step_total = sum(e["dur"] for e in work) / k
    return {
        "step_total_ms": step_total,
        "groups": groups,
        "outside_ms": step_total - sum(g["total_ms"] for g in groups.values()),
    }


class MetricLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **scalars) -> None:
        rec = {"step": int(step), "time_s": time.time() - self._t0}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
