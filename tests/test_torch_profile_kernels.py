"""profile_kernels.device_time on the CPU, with torch.profiler stood in for:
a window short of some device records still reads each kernel's time a
call, a window short of most is taken again, and a time that no window
recorded reads as NaN, never as 0."""

import math
from types import SimpleNamespace

import pytest
import torch

from plip_tpu_torch import profile_kernels as pk


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _event(name, us, device=torch.autograd.DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


class _Windows:
    """torch.profiler.profile's stand-in: the n-th window hands back the
    n-th list of events."""

    def __init__(self, windows):
        self.windows, self.opened = list(windows), 0

    def __call__(self, activities):
        outer = self

        class Window:
            def __enter__(self):
                self.events_ = outer.windows[outer.opened]
                outer.opened += 1
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self.events_

        return Window()


@pytest.fixture
def windows(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(pk, "WINDOWS", {"taken": 0, "short": 0, "refused": 0})

    def install(ws):
        fake = _Windows(ws)
        monkeypatch.setattr(torch.profiler, "profile", fake)
        return fake
    return install


def test_a_full_window_is_read_once(windows):
    host = _event("aten::sum", 999.0, torch.autograd.DeviceType.CPU)
    fake = windows([[host] + [_event("k", 10.0) for _ in range(4)]])
    ms, names = pk.device_time(lambda: None, iters=4)
    assert fake.opened == 1 and pk.WINDOWS == {"taken": 1, "short": 0, "refused": 0}
    assert ms == pytest.approx(0.010) and names == ["k"]


def test_a_lost_record_does_not_shorten_the_call(windows):
    # two kernels a call over 20 calls; one record of "a" and two of "b" lost
    events = [_event("a", 10.0) for _ in range(19)] + [_event("b", 30.0) for _ in range(18)]
    fake = windows([events])
    ms, names = pk.device_time(lambda: None, iters=20)
    assert fake.opened == 1 and pk.WINDOWS == {"taken": 1, "short": 0, "refused": 0}
    assert ms == pytest.approx(0.040) and names == ["a", "b"]


def test_kernels_launched_twice_a_call_count_twice(windows):
    events = [_event("a", 10.0) for _ in range(39)] + [_event("b", 5.0) for _ in range(20)]
    windows([events])
    assert pk.device_time(lambda: None, iters=20)[0] == pytest.approx(0.025)


@pytest.mark.parametrize("lost", [1, pk.PROFILE_TRIES - 1])
def test_a_window_short_of_most_records_is_taken_again(windows, lost):
    short = [[], [_event("k", 10.0) for _ in range(4)]]  # none, and 4 of 10 calls
    full = [_event("k", 10.0) for _ in range(9)] + [_event("k", 28.0)]
    fake = windows([short[i % 2] for i in range(lost)] + [full])
    ms, names = pk.device_time(lambda: None, iters=10)
    assert fake.opened == lost + 1
    assert pk.WINDOWS == {"taken": lost + 1, "short": lost, "refused": lost}
    assert ms == pytest.approx(0.0118) and names == ["k"]


def test_no_usable_window_reads_not_measured(windows):
    fake = windows([[] for _ in range(pk.PROFILE_TRIES)])
    ms, names = pk.device_time(lambda: None, iters=3)
    assert fake.opened == pk.PROFILE_TRIES
    assert pk.WINDOWS["refused"] == pk.PROFILE_TRIES
    assert math.isnan(ms) and names == []
    assert math.isnan(pk.bound(1.0, 1.0, pk.PEAK_FP32)[0] / ms)  # no ZeroDivisionError


def test_preprocess_cases():
    """--preprocess: K11's cases (the fused path and its plain version in the
    case's dtype, no library call) and their bounds, bytes at 3.35 TB/s: the
    input rectangle the output depends on, read once, and the output."""
    cases = pk.preprocess_cases("cpu", tiles=1)
    assert [c.label for c in cases] == [
        "1 tiles 256x256 -> 224 float32 out", "1 tiles 256x256 -> 224 bfloat16 out",
        "1 tiles 300x400 -> 224 float32 out", "1 tiles 1024x700 -> 224 float32 out",
        "1 tiles 256x256 -> 336 float32 out", "1 tiles 2048x2048 -> 224 float32 out"]
    for case, (_, h, w, out, dtype) in zip(cases, pk.PREPROCESS_CASES):
        got = case.fn()
        assert got.shape == (1, out, out, 3) and got.dtype == dtype == case.dtype
        assert torch.equal(got, case.plain())  # on the CPU the wrapper takes the plain path
        assert case.kernel == "preprocess_fused" and case.library is None
    bounds = [pk.bound(*pk.preprocess_work(n, h, w, out, dtype.itemsize), pk.PEAK_FP32)
              for n, h, w, out, dtype in pk.PREPROCESS_CASES]
    assert [b for _, b in bounds] == ["bytes"] * len(bounds)
    assert [round(ms, 4) for ms, _ in bounds[:4]] == [0.0610, 0.0380, 0.0669, 0.1601]
    assert pk.preprocess_work(256, 256, 256, 224, 4)[1] == 256 * (256 * 256 * 3 + 224 * 224 * 12)
    # only the crop's support is read: 711 of 1024 rows, 304 of 400 columns
    assert pk.preprocess_work(256, 1024, 700, 224, 4)[1] == 256 * (711 * 700 * 3 + 224 * 224 * 12)
    assert pk.preprocess_work(256, 300, 400, 224, 4)[1] == 256 * (300 * 304 * 3 + 224 * 224 * 12)
