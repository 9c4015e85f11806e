"""The port's profiling helpers (CPU).

- Program spans (``span``, ``enable_spans``, ``span_totals``,
  ``reset_spans``): off by default, where they read no clock and open no
  ``record_function`` range; on, their counts and host seconds under a
  patched clock, their ``plip:`` ranges in a profile, one thread's totals
  apart from another's; the package's own spans, once a batch or a step,
  leaving ``encode_images``, ``augment_batch`` and a ``make_train_step``
  step bit-equal; ``PrefetchLoader``'s waits; the kernel library's build
  count and spans, on a stand-in compiler.
- ``trace`` on the CPU writes a Chrome trace under its logdir and times the
  body; a profiler that fails to start raises.
- ``parse_device_trace`` on a synthetic trace written with the field names
  of ``torch.profiler``'s Chrome traces on a CUDA card (kernels, copies and
  a fill with ``args.device``; ``record_function`` ranges as
  ``gpu_user_annotation`` on the device's ``pid`` and the stream's ``tid``;
  the CPU's own events, and another device's, that must not count): its
  dict field by field, per step, from a file and from a logdir.
"""

import copy
import gzip
import json
import os
import stat
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from plip_tpu_torch.api import PLIP
from plip_tpu_torch.data.loader import PrefetchLoader
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.models.config import CLIPConfig
from plip_tpu_torch.ops import _build
from plip_tpu_torch.ops.augment import AugmentConfig, augment_batch
from plip_tpu_torch.train.contrastive import init_train_state, make_optimizer, make_train_step
from plip_tpu_torch.utils import profiling as tprof

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def spans_off():
    """Every test leaves the spans off and their totals empty."""
    yield
    tprof.enable_spans(False)
    tprof.reset_spans()


class _Ranges:
    """A stand-in for ``torch.profiler.record_function`` that logs what
    opens and closes."""

    def __init__(self):
        self.log = []

    def __call__(self, name):
        ranges = self

        class Range:
            def __enter__(self):
                ranges.log.append(("open", name))

            def __exit__(self, *exc):
                ranges.log.append(("close", name))

        return Range()


def test_spans_are_off_by_default_and_then_read_no_clock():
    """In a fresh interpreter, with ``record_function`` and the clock made
    to raise, spans open, nest and close, and record nothing."""
    code = (
        "import time, torch\n"
        "from plip_tpu_torch.utils import profiling as p\n"
        "def broken(*a, **k):\n"
        "    raise RuntimeError('read')\n"
        "torch.profiler.record_function = broken\n"
        "time.perf_counter_ns = broken\n"
        "with p.span('a'):\n"
        "    with p.span('b'):\n"
        "        pass\n"
        "print(p.span_totals())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "{}"


def test_spans_switched_off_again_record_nothing(monkeypatch):
    ranges = _Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    tprof.enable_spans(True)
    with tprof.span("a"):
        pass
    tprof.enable_spans(False)

    def broken():
        raise AssertionError("a span that is off read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", broken)
    with tprof.span("a"):
        with tprof.span("b"):
            pass
    assert ranges.log == [("open", "plip:a"), ("close", "plip:a")]
    assert {k: v.count for k, v in tprof.span_totals().items()} == {"a": 1}


@pytest.mark.parametrize("raises", [False, True])
def test_span_totals_under_a_patched_clock(monkeypatch, raises):
    """Counts and seconds by name, nested spans each their own; a body that
    raises still closes its span and range, and the error goes on."""
    ranges = _Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    ticks = iter([1_000, 1_250, 1_400, 3_000, 10_000, 10_500])
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    tprof.enable_spans(True)
    with tprof.span("step"):          # 1_000 .. 3_000
        with tprof.span("wait"):      # 1_250 .. 1_400
            pass
    try:
        with tprof.span("wait"):      # 10_000 .. 10_500
            if raises:
                raise ValueError("body")
    except ValueError:
        assert raises
    got = tprof.span_totals()
    assert got == {"step": (1, 2_000 / 1e9), "wait": (2, (150 + 500) / 1e9)}
    assert got["wait"].count == 2 and got["wait"].seconds == 650 / 1e9
    assert ranges.log == [("open", "plip:step"), ("open", "plip:wait"), ("close", "plip:wait"),
                          ("close", "plip:step"), ("open", "plip:wait"), ("close", "plip:wait")]
    tprof.reset_spans()
    assert tprof.span_totals() == {}


def test_spans_of_one_thread_stay_apart_from_anothers():
    tprof.enable_spans(True)
    go = threading.Barrier(3, timeout=60)
    seen = {}

    def worker(n):
        go.wait()
        for _ in range(n):
            with tprof.span("loader.wait"):
                pass
        seen[n] = tprof.span_totals()

    threads = [threading.Thread(target=worker, args=(n,)) for n in (3, 5)]
    for t in threads:
        t.start()
    go.wait()
    with tprof.span("train.forward"):
        pass
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert {n: {k: v.count for k, v in tot.items()} for n, tot in seen.items()} == {
        3: {"loader.wait": 3}, 5: {"loader.wait": 5}}
    assert {k: v.count for k, v in tprof.span_totals().items()} == {"train.forward": 1}


def test_spans_are_ranges_in_a_profile():
    """On the profiler's timeline a span is a ``plip:`` user range that holds
    the ranges nested in it."""
    from torch.profiler import ProfilerActivity, profile

    tprof.enable_spans(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tprof.span("train.backward"):
            with tprof.span("train.optimizer"):
                torch.ones(8).sum()
    got = {e.name: (e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(tprof.SPAN_PREFIX)}
    assert set(got) == {"plip:train.backward", "plip:train.optimizer"}
    (a0, a1), (b0, b1) = got["plip:train.backward"], got["plip:train.optimizer"]
    assert a0 <= b0 <= b1 <= a1


def _tiny_plip(model):
    class TinyPLIP(PLIP):
        @staticmethod
        def _load_model(model_name):
            return model, model.cfg

    return TinyPLIP("tiny", device="cpu", tokenizer=object())


@pytest.mark.parametrize("sizes", [(40,), (40, 48)])
def test_encode_images_spans(sizes):
    """The same embeddings with spans off and on; each encode span once a
    batch, the fetch once a call. One size: the staged route, no
    ``preprocess.stack``, ``preprocess.h2d`` twice a batch (the copy issued
    in ``encode_images``, then ``preprocess_batch``'s own around a tensor
    already on the device). Two sizes: the grouped route, ``stack``, ``h2d``
    and ``resize`` once a size in a batch."""
    model = CLIP(CLIPConfig.tiny()).init_params(torch.Generator().manual_seed(0))
    plip = _tiny_plip(model)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (sizes[i % len(sizes)],) * 2 + (3,), np.uint8)
              for i in range(5)]
    off = plip.encode_images(images, batch_size=3, num_workers=2)
    tprof.enable_spans(True)
    on = plip.encode_images(images, batch_size=3, num_workers=2)
    np.testing.assert_array_equal(on, off)
    got = {k: v.count for k, v in tprof.span_totals().items()}
    if len(sizes) == 1:
        assert got == {"encode.decode": 2, "preprocess.h2d": 2 * 2,
                       "preprocess.resize": 2, "encode.tower": 2, "encode.fetch": 1}
    else:
        per_batch = len(sizes)  # both batches hold every size
        assert got == {"encode.decode": 2, "preprocess.stack": 2 * per_batch,
                       "preprocess.h2d": 2 * per_batch, "preprocess.resize": 2 * per_batch,
                       "encode.tower": 2, "encode.fetch": 1}


def _train_inputs(cfg, B=4):
    rng = np.random.default_rng(3)
    pixels = torch.from_numpy(rng.standard_normal(
        (B, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32))
    ids = np.zeros((B, cfg.text.context_length), np.int64)
    ids[:, 0] = 1
    ids[:, 1:4] = rng.integers(2, 60, (B, 3))
    ids[:, 4] = cfg.text.eot
    return pixels, torch.from_numpy(ids)


def test_train_step_spans():
    """A one-pass step with spans on gives the loss and the parameters of
    the step with spans off, bit for bit; forward, backward and optimizer
    once each."""
    cfg = CLIPConfig.tiny()
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(1))
    pixels, ids = _train_inputs(cfg)
    out = []
    for on in (False, True):
        tprof.enable_spans(on)
        opt = make_optimizer(base_lr=1e-3, warmup=1, total_steps=10)
        state = init_train_state(copy.deepcopy(model), opt)
        state, metrics = make_train_step(cfg, opt)(state, pixels, ids)
        out.append((metrics["loss"], dict(state.model.named_parameters())))
    assert torch.equal(out[0][0], out[1][0])
    for k, p in out[0][1].items():
        assert torch.equal(p, out[1][1][k]), k
    assert {k: v.count for k, v in tprof.span_totals().items()} == {
        "train.forward": 1, "train.backward": 1, "train.optimizer": 1}


def test_augment_batch_spans():
    images = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 40, 40, 3),
                                                                np.uint8))
    cfg = AugmentConfig(out_size=32)
    off = augment_batch(torch.Generator().manual_seed(9), images, cfg)
    tprof.enable_spans(True)
    on = augment_batch(torch.Generator().manual_seed(9), images, cfg)
    assert torch.equal(on, off)
    assert {k: v.count for k, v in tprof.span_totals().items()} == {
        "augment.draw": 1, "augment.warp": 1}


@pytest.mark.parametrize("taken", [3, None])
def test_prefetch_loader_waits(taken):
    """One ``loader.wait`` a batch taken, and one more for the end of an
    epoch read to its end; the batches as without spans."""
    data = [np.full((2,), i, np.int32) for i in range(10)]  # 5 batches of 2
    want = [b.tolist() for (b, _) in PrefetchLoader(data, 2, num_workers=2)]
    tprof.enable_spans(True)
    it = iter(PrefetchLoader(data, 2, num_workers=2))
    got = []
    for (batch, n) in it:
        got.append(batch.tolist())
        if len(got) == taken:
            break
    it.close()
    assert got == want[:taken]
    waits = tprof.span_totals()["loader.wait"].count
    assert waits == (taken if taken else len(want) + 1)


def test_kernel_library_build_is_counted_and_spanned(monkeypatch, tmp_path):
    """A build compiles once and counts once; a library found built is not
    compiled again; the ctypes load is a span of its own."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    # a stand-in compiler: writes the file after -o
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo built > \"$2\"; fi; shift\ndone\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    before = _build.COMPILES
    tprof.enable_spans(True)
    lib = _build.build()
    assert lib.read_text() == "built\n" and lib.parent == tmp_path / "_build"
    assert _build.load() == ("loaded", str(lib))
    assert _build.build() == lib
    assert _build.COMPILES == before + 1
    assert {k: v.count for k, v in tprof.span_totals().items()} == {
        "kernels.build": 1, "kernels.load": 1}


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "prof")
    with tprof.trace(logdir) as info:
        with torch.profiler.record_function("encode"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert info["wall_time_s"] > 0
    assert os.path.dirname(info["trace_path"]) == logdir
    assert info["trace_path"].endswith(".pt.trace.json.gz")
    with gzip.open(info["trace_path"], "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "encode" in names
    # no device on the CPU: no device time, no device range
    got = tprof.parse_device_trace(logdir)
    assert got == {"step_total_ms": 0.0, "groups": {}, "outside_ms": 0.0}
    with tprof.trace() as info:  # no logdir: a timer only
        pass
    assert set(info) == {"wall_time_s"}


def test_trace_raises_when_the_profiler_fails(monkeypatch, tmp_path):
    def broken(self):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler.profile, "__enter__", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with tprof.trace(str(tmp_path)):
            pass


def _x(cat, name, ts, dur, pid=0, tid=7, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _synthetic_trace(path, gz=True):
    """Two steps of an "encode" range (copy in, two kernels, copy out), a
    "loss" range nested in the second, a kernel outside every range, a
    kernel on device 1, and the CPU's own events."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for s, t in enumerate((1000.0, 5000.0)):
        ev += [
            _x("user_annotation", "encode", t - 50, 3000, pid=118, tid=118),
            _x("cpu_op", "aten::mm", t - 40, 30, pid=118, tid=118),
            _x("cuda_runtime", "cudaLaunchKernel", t - 30, 5, pid=118, tid=118),
            _x("gpu_user_annotation", "encode", t, 1000 + 10 * s),
            _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t, 100, device=0, stream=7),
            _x("kernel", "gemm", t + 150, 400, device=0, stream=7),
            _x("kernel", "attn_core", t + 600, 300 + 10 * s, device=0, stream=7),
            _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", t + 950 + 10 * s, 50,
               device=0, stream=7),
        ]
    ev += [
        _x("gpu_user_annotation", "loss", 5600, 310),  # nested in step 2's encode
        _x("gpu_memset", "Memset (Device)", 9000, 20, device=0, stream=7),  # no range
        _x("kernel", "gemm", 5150, 400, pid=1, device=1, stream=7),  # another card
        _x("gpu_user_annotation", "encode", 5000, 1010, pid=1),
    ]
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)


def _check_synthetic(got, n_steps):
    per = 1e3 * n_steps
    assert got["step_total_ms"] == pytest.approx((2 * (100 + 400 + 50) + 300 + 310 + 20) / per)
    assert set(got["groups"]) == {"encode", "loss"}
    enc = got["groups"]["encode"]
    assert enc["total_ms"] == pytest.approx((2 * (100 + 400 + 50) + 300 + 310) / per)
    assert enc["ops"] == [("gemm", pytest.approx(800 / per)),
                          ("attn_core", pytest.approx(610 / per)),
                          ("Memcpy HtoD (Pinned -> Device)", pytest.approx(200 / per)),
                          ("Memcpy DtoH (Device -> Pinned)", pytest.approx(100 / per))]
    assert got["groups"]["loss"] == {"total_ms": pytest.approx(310 / per),
                                     "ops": [("attn_core", pytest.approx(310 / per))]}
    assert got["outside_ms"] == pytest.approx(
        got["step_total_ms"] - enc["total_ms"] - 310 / per)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_parse_device_trace_file(tmp_path, n_steps):
    path = str(tmp_path / "host.123.pt.trace.json.gz")
    _synthetic_trace(path)
    _check_synthetic(tprof.parse_device_trace(path, n_steps=n_steps), n_steps)
    plain = str(tmp_path / "host.124.pt.trace.json")
    _synthetic_trace(plain, gz=False)
    _check_synthetic(tprof.parse_device_trace(plain, n_steps=n_steps), n_steps)


def test_parse_device_trace_logdir_takes_the_newest(tmp_path):
    old = str(tmp_path / "a.1.pt.trace.json.gz")
    with gzip.open(old, "wt") as f:
        json.dump({"traceEvents": [_x("kernel", "k", 0, 5, device=0)]}, f)
    os.utime(old, (1, 1))
    _synthetic_trace(str(tmp_path / "b.2.pt.trace.json.gz"))
    _check_synthetic(tprof.parse_device_trace(str(tmp_path), n_steps=2), 2)
    got = tprof.parse_device_trace(str(tmp_path / "b.2.pt.trace.json.gz"), device=1)
    assert got["step_total_ms"] == pytest.approx(0.4)
    assert got["groups"]["encode"]["ops"] == [("gemm", pytest.approx(0.4))]
    with pytest.raises(FileNotFoundError):
        tprof.parse_device_trace(str(tmp_path / "empty_dir_missing"))
