"""The benchmark's yardstick arithmetic: operation counts against a hand count,
busy time as a union of kernel intervals, idle gaps by span, the traffic's
determinism by seed, and the loops and readers found by name."""

import importlib
import json
from pathlib import Path

import pytest

from benchmark import counts, readers, traffic
from benchmark.loops.encode import split
from benchmark.loops.train import epochs
from benchmark.trace import idle_by_span, union_seconds

HERE = Path(__file__).resolve().parent.parent


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def _hand_vision(p, w, layers, tokens, e):
    s = tokens + 1
    return (2 * tokens * p * p * 3 * w + layers * (24 * w * w * s + 4 * s * s * w)
            + 2 * w * e)


def _hand_text(w, layers, s, e):
    return layers * (24 * w * w * s + 2 * s * (s + 1) * w) + 2 * w * e


@pytest.mark.parametrize("name,vision,text", [
    ("plip-vit-b32", _hand_vision(32, 768, 12, 49, 512), _hand_text(512, 12, 77, 512)),
    ("clip-vit-l14", _hand_vision(14, 1024, 24, 256, 768), _hand_text(768, 12, 77, 768)),
])
def test_counts_against_hand_count(name, vision, text):
    cfg = _cfg(name)
    assert counts.total_ops(counts.vision_forward(cfg, 1, 4)) == pytest.approx(vision, rel=1e-12)
    assert counts.total_ops(counts.text_forward(cfg, 1, 4)) == pytest.approx(text, rel=1e-12)
    b, e = 64, cfg["embed_dim"]
    step = counts.total_ops(counts.train_step(cfg, b, 2))
    assert step == pytest.approx(3 * (b * (vision + text) + 2 * b * b * e), rel=1e-12)


def test_counts_at_published_sizes():
    # ViT-B/32: 8.8 GFLOP an image, 44 GFLOP a training pair; L/14: 162 and 525
    b32, l14 = _cfg("plip-vit-b32"), _cfg("clip-vit-l14")
    def gflop(works, n=1):
        return counts.total_ops(works) / n / 1e9

    assert gflop(counts.vision_forward(b32, 1, 4)) == pytest.approx(8.82, abs=0.01)
    assert gflop(counts.train_step(b32, 128, 4), 128) == pytest.approx(44.2, abs=0.1)
    assert gflop(counts.vision_forward(l14, 1, 2)) == pytest.approx(162.0, abs=0.5)
    assert gflop(counts.train_step(l14, 64, 2), 64) == pytest.approx(525.5, abs=1.0)


def test_least_seconds_takes_the_longer_bound():
    # a [1, 4096] x [4096, 4096] product in bf16 is bound by its 32 MiB of weights
    works = [(2.0 * 4096 * 4096, 2.0 * (4096 + 4096 * 4096 + 4096))]
    t = counts.least_seconds(works, 989e12, 3.35e12)
    assert t == pytest.approx(works[0][1] / 3.35e12)


def test_union_counts_overlaps_once():
    busy, merged = union_seconds([(0, 10), (5, 20), (30, 40), (35, 36), (40, 45)])
    assert busy == pytest.approx(35e-9)
    assert merged == [(0, 20), (30, 45)]


def test_idle_gaps_named_by_innermost_span():
    merged = [(10, 20), (60, 70)]
    spans = [(0, 100, "request"), (25, 50, "step")]
    idle = idle_by_span(merged, 0, 100, spans)
    # gaps: [0,10) mid 5 -> request; [20,60) mid 40 -> step; [70,100) -> request
    assert idle == {"request": pytest.approx(40e-9), "step": pytest.approx(40e-9)}
    assert idle_by_span([], 0, 10, []) == {"none": pytest.approx(10e-9)}


def test_encode_requests_fixed_size_and_by_seed():
    mix = json.loads((HERE / "mixes" / "encode.fp32.json").read_text())
    pools = [traffic.tile_pool(16, 8, seed, "cpu") for seed in (1, 1, 2 ** 31 + 5)]
    assert (pools[0] == pools[1]).all() and not (pools[0] == pools[2]).all()
    reqs = traffic.encode_requests(pools[0], 4)
    assert [len(r) for r in reqs] == [4] * 4
    assert all((reqs[k][j] == pools[0][4 * k + j]).all() for k in range(4) for j in range(4))
    with pytest.raises(ValueError):
        traffic.encode_requests(pools[0], 5)
    assert mix["pool_tiles"] % mix["request_tiles"] == 0


def test_captions_and_rows_deterministic():
    mix = json.loads((HERE / "mixes" / "train.fp32.b128.json").read_text())
    a, b = traffic.captions(mix, 50, 7), traffic.captions(mix, 50, 7)
    assert a == b and a != traffic.captions(mix, 50, 8)
    n_words = sorted(len(c.split()) for c in traffic.captions(mix, 13, 9))
    assert n_words == list(range(mix["caption_words_min"], mix["caption_words_max"] + 1))
    rows = traffic.train_rows(5000, 2048, 3)
    assert len(set(rows[:2048].tolist())) == 2048
    assert (rows == traffic.train_rows(5000, 2048, 3)).all()


def test_split_cuts_as_encode_images_does():
    assert split(700, 256) == [256, 256, 188]
    assert split(256, 256) == [256]


def test_epochs_cycle_full_batches_and_close():
    closed = []

    def loader():
        def gen():
            try:
                yield from [((f"i{k}", f"c{k}"), n) for k, n in enumerate((4, 4, 2))]
            finally:
                closed.append(True)
        return gen()

    it = epochs(loader, 4)
    got = [next(it) for _ in range(5)]
    assert got == [("i0", "c0"), ("i1", "c1")] * 2 + [("i0", "c0")]
    it.close()
    assert closed == [True] * 3


def test_every_mix_kind_has_a_loop():
    for path in (HERE / "mixes").glob("*.json"):
        kind = json.loads(path.read_text())["kind"]
        assert callable(importlib.import_module(f"benchmark.loops.{kind}").run), path


def test_readers_take_counted_work_of_any_kind():
    cfg = _cfg("plip-vit-b32")
    works = counts.vision_forward(cfg, 256, 4) * 10
    trace = {"busy_s": 2.0, "copy_s": 0.5, "window_s": 4.0, "kernels": 5120}
    run = readers.Run(cfg=cfg, dtype="float32", trace=trace,
                      span_seconds={"x": 0.2, "loader.next": 0.1}, works=works, items=2560, steps=10, memory_peak_bytes=2 ** 30,
                      peaks={"float32": 67e12, "bytes_per_s": 3.35e12})
    assert readers.idle_share(run) == pytest.approx(50.0)
    assert readers.mfu(run) == pytest.approx(100 * counts.total_ops(works) / 4.0 / 67e12)
    assert readers.kernel_roofline(run) == pytest.approx(
        100 * counts.least_seconds(works, 67e12, 3.35e12) / 2.0)
    assert readers.launches_per(run, per_item=True) == pytest.approx(2.0)
    assert readers.launches_per(run, per_item=False) == pytest.approx(512.0)
    assert readers.span_ms_per_step(run, "x") == pytest.approx(20.0)
    assert readers.span_ms_per_step(run, "y") is None
    assert readers.copy_us_per_item(run) == pytest.approx(1e6 * 0.5 / 2560)
    assert readers.mfu(readers.Run(**{**run.__dict__, "trace": None})) is None
    for m in json.loads((HERE.parent / "BENCHMARK.json").read_text())["per_layer"]:
        value = readers.load_reader(m["name"])(run)
        assert value is not None and value > 0, m["name"]


class _Event:
    """A profiler event of a PyTorch without ``activity_type``."""

    def __init__(self, name, device, start, end, annotation=False):
        self._n, self._d, self._s, self._e, self._a = name, device, start, end, annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def test_reduce_events_from_device_and_name():
    from benchmark.trace import reduce_events

    events = [
        _Event("bench:step", "CPU", 0, 100, True),
        _Event("bench:step", "CUDA", 0, 100, True),   # its projection: not device work
        _Event("aten::mm", "CPU", 5, 6),
        _Event("sgemm_kernel", "CUDA", 10, 40),
        _Event("Memcpy HtoD (Pinned -> Device)", "CUDA", 30, 50),
        _Event("other_kernel", "CUDA", 60, 70),
        _Event("late_kernel", "CUDA", 95, 130),       # clipped at the window's end
    ]
    s = reduce_events(events, 0, 100)
    # busy: the kernels alone, [10, 40) + [60, 70) + [95, 100); the copy apart
    assert s["busy_s"] == pytest.approx(45e-9)
    assert s["copy_s"] == pytest.approx(20e-9)
    assert s["kernels"] == 3
    assert s["window_s"] == pytest.approx(100e-9)
    assert s["device_ops"][0] == ("sgemm_kernel", pytest.approx(30e-9))
    assert dict(s["device_ops"])["Memcpy HtoD (Pinned -> Device)"] == pytest.approx(20e-9)
    assert dict(s["idle_gaps"]) == {"step": pytest.approx(55e-9)}
