"""The multi-process ``CLIPTuner``: two processes on the CPU (gloo).

- (iv) The coordinated auto-accumulation: with ``accum_steps="auto"`` the
  first step fails with an out-of-memory error on rank 0 alone (after it
  ran everywhere); both ranks agree on ``accum_steps=2``, rank 1 discards
  its good step, and both end on the same parameters.
- (vi) ADVICE r5 fault (a) of the JAX tuner: ``valid_evaluation`` of 5 rows
  at batch 4 (a remainder of one row, so rank 1 holds none of it) gives the
  one-process scalar on both ranks.
- The full state of the run (``save_full_state="orbax"``: a sharded
  directory written by both ranks) resumes in a second two-process tuner;
  rank 0 alone logs the train lines and writes.
- (v) ADVICE r5 fault (b): an error other than an OOM in rank 0's first
  step ends rank 1 with an error at once, well inside the group's 120 s
  timeout, where the JAX tuner left it waiting in ``agree_max_int``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save

from test_torch_parallel import spawn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GROUP_TIMEOUT_S = 120

_PRELUDE = r"""
import hashlib, json, os, sys, time
from types import SimpleNamespace
import numpy as np
import torch
import plip_tpu_torch.train.clip_tuner as ct
from plip_tpu_torch.data.datasets import ImageCaptionDataset
from plip_tpu_torch.data.loader import PrefetchLoader
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import create_mesh

rank, d = int(os.environ["_RANK"]), os.environ["_DIR"]
assert distributed.initialize(os.environ["_COORD"], 2, rank, timeout_s=%(timeout)d)
mesh = create_mesh(dp=2)
data = json.load(open(os.path.join(d, "data.json")))
records = []
log = SimpleNamespace(info=lambda m, *a: records.append(m %% a if a else m),
                      warning=lambda m, *a: records.append(m %% a if a else m))
real_make = ct.make_train_step
built = []


def failing_make(error):
    def make(cfg, opt, dtype=None, remat=False, accum_steps=1, mesh=None):
        built.append(accum_steps)
        step = real_make(cfg, opt, dtype=dtype, remat=remat, accum_steps=accum_steps,
                         mesh=mesh)

        def wrapped(state, px, ids):
            out = step(state, px, ids)
            if accum_steps < 2 and rank == 0:
                float(out[1]["loss"])  # the step ran on both ranks
                raise error
            return out

        return wrapped

    return make


def tuner(**kw):
    t = ct.CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224, optimizer="AdamW"),
                     backbone=os.path.join(d, "tiny.npz"), lr=1e-4, warmup=2, device="cpu",
                     mesh=mesh, **kw)
    t.logging = log
    return t


def digest(model):
    h = hashlib.sha256()
    for _, p in sorted(model.state_dict().items()):
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()
""" % {"timeout": GROUP_TIMEOUT_S}

_CHILD_ACCUM = _PRELUDE + r"""
ct.make_train_step = failing_make(torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)"))
t = tuner(accum_steps="auto")
mine = os.path.join(d, f"rank{rank}")
os.makedirs(mine, exist_ok=True)
suffix = t.tuner(data["train"], data["valid"], save_directory=d, batch_size=4, epochs=1,
                 evaluation_steps=0, num_workers=2, start_time="aa", save_full_state="orbax")

# (vi) a remainder batch: 5 rows at batch 4
def loader():
    return PrefetchLoader(ImageCaptionDataset(data["valid5"]), 4, num_workers=2)
v_mesh = t.valid_evaluation(loader())
t.mesh = None
v_one = t.valid_evaluation(loader())
t.mesh = mesh

# resume the sharded full state in a second two-process tuner
ct.make_train_step = real_make
t2 = tuner(accum_steps=2)
t2.tuner(data["train"], data["valid"], save_directory=mine, batch_size=4, epochs=1,
         evaluation_steps=0, num_workers=2, start_time="bb",
         resume_from=os.path.join(d, "epoch_0_aa_model.orbax"))
print("RESULT " + json.dumps({
    "rank": rank, "built": built, "suffix": suffix, "records": records,
    "digest": digest(t.model), "digest2": digest(t2.model), "v_mesh": v_mesh, "v_one": v_one,
    "step": t.state.step, "resumed": [t2.state.step, t2.state.opt_state.count],
    "dir": sorted(os.listdir(os.path.join(d, "epoch_0_aa_model.orbax"))),
    "mine": sorted(os.listdir(mine))}))
"""

_CHILD_FAULT = _PRELUDE + r"""
ct.make_train_step = failing_make(ValueError("a fault in the step (simulated)"))
t = tuner(accum_steps="auto")
t0 = time.perf_counter()
try:
    t.tuner(data["train"], data["valid"], save_directory=d, batch_size=4, epochs=1,
            evaluation_steps=0, num_workers=2, start_time="cc")
finally:
    print(f"ELAPSED {time.perf_counter() - t0:.3f}", flush=True)
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tuner2")
    cfg = CLIPConfig(
        vision=VisionConfig(width=32, layers=2, heads=2, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=2, heads=2, vocab_size=49408, context_length=77),
        embed_dim=16)
    jax_save(str(d / "tiny.npz"), jclip.init_params(jax.random.PRNGKey(3), cfg), cfg)
    rng = np.random.default_rng(0)
    images, captions = [], []
    for i in range(8):
        p = str(d / f"im_{i}.png")
        Image.fromarray(rng.integers(0, 256, (240, 260, 3), dtype=np.uint8)).save(p)
        images.append(p)
        captions.append(f"an H&E image of class {i % 3}")
    with open(d / "data.json", "w") as f:
        json.dump({"train": {"image": images, "caption": captions},
                   "valid": {"image": images[:4], "caption": captions[:4]},
                   "valid5": {"image": images[2:7], "caption": captions[2:7]}}, f)
    return d


@pytest.fixture(scope="module")
def accum_run(data):
    outs = spawn(_CHILD_ACCUM, data)
    results = {}
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\n{out}\n{err[-4000:]}"
        r = json.loads([l for l in out.splitlines() if l.startswith("RESULT ")][0][7:])
        results[r["rank"]] = r
    return results


def test_coordinated_auto_accum(accum_run):
    for rank, marker in ((0, "locally"), (1, "on a peer")):
        r = accum_run[rank]
        assert r["built"][:2] == [1, 2], r["built"]
        assert any(marker in m and "accum_steps=2" in m for m in r["records"]), r["records"]
        assert r["step"] == 2
    assert accum_run[0]["digest"] == accum_run[1]["digest"]


def test_rank_zero_alone_logs_and_writes(accum_run, data):
    train_lines = [[m for m in accum_run[r]["records"] if "[Train - this batch]" in m]
                   for r in (0, 1)]
    assert len(train_lines[0]) == 4 and train_lines[1] == []  # two tuners, 2 steps each
    assert accum_run[0]["mine"] == ["epoch_0_bb_model.npz"] and accum_run[1]["mine"] == []
    assert accum_run[0]["suffix"] == "_aa_model.orbax"
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata",
            "clip_config.json"} <= set(accum_run[0]["dir"])


def test_valid_evaluation_remainder_gives_the_one_process_scalar(accum_run):
    for r in accum_run.values():
        assert np.isfinite(r["v_mesh"])
        assert r["v_mesh"] == pytest.approx(r["v_one"], rel=1e-5)
    assert accum_run[0]["v_mesh"] == accum_run[1]["v_mesh"]


def test_sharded_full_state_resumes_in_two_processes(accum_run):
    for r in accum_run.values():
        assert r["resumed"] == [4, 4]  # 2 steps saved, 2 more
    assert accum_run[0]["digest2"] == accum_run[1]["digest2"]


def test_a_peer_error_ends_the_other_rank_at_once(data):
    outs = spawn(_CHILD_FAULT, data, timeout=GROUP_TIMEOUT_S + 30)
    (rc0, out0, err0), (rc1, out1, err1) = outs
    assert rc0 != 0 and "ValueError: a fault in the step" in err0, err0[-2000:]
    assert rc1 != 0 and "a peer process failed its first step" in err1, err1[-2000:]
    for out in (out0, out1):
        elapsed = float([l for l in out.splitlines() if l.startswith("ELAPSED")][0].split()[1])
        assert elapsed < GROUP_TIMEOUT_S / 4, elapsed
