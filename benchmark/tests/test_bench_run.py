"""Whole runs of the harness on the CPU at a small size, past its look for a
card: a sound run comes out correct, and each fault a cell can have, planted
in the timed path, makes ``correct`` false. Also: no card, no result; no JAX
loaded; and the controls on the card (marked ``cuda``)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from benchmark import run

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(workload):
    """The cell's configuration and mix at a size the CPU runs in seconds."""
    cell = {w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())
            ["workloads"]}[workload]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    cfg["vision"] = {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 4}
    cfg["text"] = dict(cfg["text"], width=32, layers=2, heads=4)
    cfg["embed_dim"] = 24
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    mix.update(pool_tiles=48, tile_px=48)
    if mix["kind"] == "encode":
        mix.update(request_tiles=16, batch_size=8, check_requests=2, dtype="float32")
    else:
        mix.update(batch_size=8, epoch_pairs=28, dtype="float32")
    return cfg, mix


def run_small(workload, seconds=0.3):
    cfg, mix = small(workload)
    line, _ = run.run_cell(workload, 2 ** 31 + 11, seconds, False, "cpu", cfg=cfg, mix=mix,
                           t0=time.perf_counter())
    return line


@pytest.mark.parametrize("workload", ["plip-vit-b32.encode.fp32", "plip-vit-b32.train.fp32"])
def test_sound_run_is_correct(workload):
    line = run_small(workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


def test_fault_answer_altered_where_produced(monkeypatch):
    from plip_tpu_torch.models.clip import CLIP

    real = CLIP.encode_image

    def altered(self, pixels, dtype=torch.float32, remat=False):
        out = real(self, pixels, dtype, remat).clone()
        out[0, 0] += 0.05 * out[0].norm()
        return out

    monkeypatch.setattr(CLIP, "encode_image", altered)
    line = run_small("plip-vit-b32.encode.fp32")
    assert not line["correct"] and line["checks"]["emb_err"]["value"] > 0.01


def test_fault_state_unchanged(monkeypatch):
    from plip_tpu_torch.train import contrastive

    def make_train_step(cfg, optimizer, dtype=torch.float32, remat=False, **_):
        def step(state, pixels, ids):
            with torch.no_grad():
                _, metrics = contrastive.clip_loss(state.model, pixels, ids, dtype)
            return state, metrics
        return step

    monkeypatch.setattr(contrastive, "make_train_step", make_train_step)
    line = run_small("plip-vit-b32.train.fp32")
    assert not line["correct"]
    assert line["checks"]["delta_gap"]["value"] == pytest.approx(1.0)


def test_fault_half_batch(monkeypatch):
    from plip_tpu_torch.train import contrastive

    real = contrastive.clip_loss

    def half(model, pixels, ids, *args, **kw):
        n = pixels.shape[0] // 2
        return real(model, pixels[:n], ids[:n], *args, **kw)

    monkeypatch.setattr(contrastive, "clip_loss", half)
    line = run_small("plip-vit-b32.train.fp32")
    assert not line["correct"] and line["checks"]["loss_gap"]["value"] > 0.05


def test_fault_token_altered(monkeypatch):
    import plip_tpu_torch.tokenizer as tk

    real = tk.default_tokenizer

    def altered():
        tok = real()
        tokenize = tok.tokenize

        def bad(texts, *a, **kw):
            ids = tokenize(texts, *a, **kw)
            ids[0, 1] = (ids[0, 1] + 1) % 49000
            return ids
        tok.tokenize = bad
        return tok

    monkeypatch.setattr(tk, "default_tokenizer", altered)
    line = run_small("plip-vit-b32.train.fp32")
    assert not line["correct"] and line["checks"]["tokens"]["value"] == 0


def test_no_jax_loaded_by_a_run():
    code = textwrap.dedent("""
        import sys, time
        sys.path.insert(0, sys.argv[1])
        from benchmark import run, calibrate, readers
        from benchmark.tests.test_bench_run import run_small
        for w in ("plip-vit-b32.encode.fp32", "plip-vit-b32.train.fp32"):
            run_small(w, 0.1)
        for m in json.load(open(sys.argv[1] + "/BENCHMARK.json"))["per_layer"]:
            readers.load_reader(m["name"])
        print("FORBIDDEN", run.forbidden_modules())
    """).replace("import sys, time", "import json, sys, time")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert "FORBIDDEN []" in out.stdout, out.stderr[-3000:]
    # and no file of the harness names them
    for path in HERE.rglob("*.py"):
        for ln in path.read_text().splitlines():
            words = ln.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in run.FORBIDDEN, (path, ln)


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "plip_tpu_torch_fake", object())
    assert "plip_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "plip_tpu.fake", object())
    assert run.forbidden_modules() == ["plip_tpu.fake"]


def _bench(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "plip-vit-b32.encode.fp32", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=cwd, env=env)


def test_no_card_no_result():
    out = _bench(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _bench(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload,controls,seconds", [
    ("plip-vit-b32.encode.fp32", ["tf32"], 8.0),
    ("plip-vit-b32.train.fp32", ["tf32", "half_batch"], 2.0),
    ("clip-vit-l14.train.bf16", ["fp8", "half_batch"], 2.0),
])
def test_controls_fail_on_the_card(workload, controls, seconds):
    """Each control in the program's place, at the cell's own size and load,
    fails one of the cell's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    line, res = run.run_cell(workload, 2 ** 31 + 23, seconds, False, "cuda", controls=controls,
                             t0=time.perf_counter())
    assert line["correct"], line["checks"]
    for name, got in res.controls.items():
        assert any(v > limits[k] for k, v in got.items()), (name, got, limits)
