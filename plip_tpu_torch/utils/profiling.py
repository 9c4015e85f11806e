"""Tracing and profiling: the port's program spans, and the profiler's
trace and its device time.

- ``span(name)``: a program span, a context manager around a coarse piece
  of host work (staging a batch, a step's backward, a wait on the loader).
  Off by default; ``enable_spans(True)`` turns them on for the process.
  When on, a span adds its count and host seconds (``time.perf_counter_ns``)
  to totals kept by thread and name (``span_totals``, ``reset_spans``), and
  opens ``torch.profiler.record_function("plip:" + name)``, so a profile
  puts it on the timeline of the card's kernels and copies. When off it
  reads no clock and opens no range.
- ``trace``: a context manager around ``torch.profiler.profile`` (CPU, and
  CUDA where a card is present) that writes the Chrome trace
  (``*.pt.trace.json.gz``) under ``logdir``; its dict gains
  ``wall_time_s``. A profiler that fails to start raises.
- ``parse_device_trace``: the device time of a trace, in total and by
  ``torch.profiler.record_function`` range, per step.

The package's spans, each opened on the caller's thread:

- ``encode.decode``, ``encode.tower``, ``encode.fetch``: a batch's decode
  (the native lane, or ``load_image_rgb`` on the call's thread pool), the
  vision tower on it, and the embeddings' way back to the host, in
  ``PLIP.encode_images``;
- ``preprocess.stack``: ``np.stack`` of a batch in ``preprocess_images``;
  ``preprocess.h2d`` and ``preprocess.resize``: its copy to the device, and
  the resize, crop and normalize, in ``preprocess_batch``;
- ``train.forward``, ``train.backward``: the towers and the loss, and
  ``loss.backward()``, in ``make_train_step``'s one-pass step;
  ``train.optimizer``: its AdamW update and the logit-scale clamp;
- ``augment.draw``, ``augment.warp``: ``augment_batch``'s warps drawn on
  the host (and their copy to the device), and ``warp_normalize``;
- ``loader.wait``: ``PrefetchLoader``'s consumer blocked on the next batch
  (once a batch, and once at an epoch's end);
- ``kernels.build``, ``kernels.load``: compiling the kernel library
  (``ops._build.COMPILES`` counts these builds, spans on or off) and
  loading it.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # the device's own work
RANGE_CAT = "gpu_user_annotation"  # a record_function range on the device timeline
SPAN_PREFIX = "plip:"  # a program span's range name: the prefix, then the span's

_spans_on = False
_totals: Dict[int, Dict[str, list]] = {}  # thread ident -> name -> [count, ns]
_OFF = contextlib.nullcontext()


class SpanTotal(NamedTuple):
    count: int
    seconds: float


def enable_spans(on: bool = True) -> None:
    """Turn the program's spans on or off for the whole process."""
    global _spans_on
    _spans_on = bool(on)


def span(name: str):
    """A program span named ``name`` (the module doc); a no-op unless
    ``enable_spans(True)``."""
    if not _spans_on:
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(SPAN_PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self.t0
        self.range.__exit__(*exc)
        total = _totals.setdefault(threading.get_ident(), {}).setdefault(self.name, [0, 0])
        total[0] += 1
        total[1] += ns


def span_totals() -> Dict[str, SpanTotal]:
    """The calling thread's spans since the last ``reset_spans``: count and
    host seconds by name."""
    return {k: SpanTotal(n, ns / 1e9)
            for k, (n, ns) in _totals.get(threading.get_ident(), {}).items()}


def reset_spans() -> None:
    """Clear every thread's totals."""
    _totals.clear()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, name: str = "plip_tpu_torch"):
    """Profile the body with ``torch.profiler`` when ``logdir`` is given.
    Yields a dict that gains, on exit, ``wall_time_s`` (the body's host
    wall, the card synchronized) and with ``logdir`` also ``trace_path``
    (the Chrome trace written there) and ``profiler`` (the finished
    ``torch.profiler.profile``, for its ``events()``)."""
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
