"""The port's profiling helpers (CPU).

- ``ThroughputMeter`` and ``MetricLogger`` against the JAX package's on
  the same sequence of steps, the clocks patched.
- ``trace`` on the CPU writes a Chrome trace under its logdir and times the
  body; a profiler that fails to start raises.
- ``parse_device_trace`` on a synthetic trace written with the field names
  of ``torch.profiler``'s Chrome traces on a CUDA card (kernels, copies and
  a fill with ``args.device``; ``record_function`` ranges as
  ``gpu_user_annotation`` on the device's ``pid`` and the stream's ``tid``;
  the CPU's own events, and another device's, that must not count): its
  dict field by field, per step, from a file and from a logdir.
"""

import gzip
import json
import os
import time

import pytest
import torch

from plip_tpu.utils import profiling as jprof
from plip_tpu_torch.utils import profiling as tprof


def _clock(monkeypatch, name, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, name, lambda: next(it))


@pytest.mark.parametrize("window", [100, 3])
def test_throughput_meter_matches_jax(monkeypatch, window):
    ticks = [9.0, 10.0, 10.5, 10.75, 12.0, 12.1, 12.2, 15.0]
    counts = [8, 8, 16, 4, 4, 32]
    out = []
    for mod in (jprof, tprof):
        _clock(monkeypatch, "perf_counter", ticks)
        m = mod.ThroughputMeter(window=window)
        m.step(99)  # before start: ignored
        m.start()
        for n in counts:
            m.step(n)
        out.append((m.summary(), m.latency_percentile(10), m.items_per_sec))
    assert out[0] == out[1]
    assert out[1][0]["total_items"] == sum(counts)


def test_metric_logger_matches_jax(monkeypatch, tmp_path):
    records = []
    for mod, tag in ((jprof, "jax"), (tprof, "port")):
        _clock(monkeypatch, "time", [100.0, 100.25, 101.5, 103.0])
        ml = mod.MetricLogger(str(tmp_path / tag / "m.jsonl"))
        ml.log(0, loss=torch.tensor(2.5).item(), lr=1e-4, note="warmup")
        ml.log(1, loss=1.75, acc=torch.tensor(0.5))
        ml.log(2.0, loss=1)
        ml.close()
        records.append((tmp_path / tag / "m.jsonl").read_text())
    assert records[0] == records[1]
    assert [json.loads(l)["step"] for l in records[1].splitlines()] == [0, 1, 2]


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
