"""``CLIPTuner`` under tensor parallelism: two processes on the CPU (gloo),
a ``tp=2`` mesh, one module-scoped spawn.

The two ranks hold the same rows (dp rank 0) and must draw the same
augmentations: their generator is seeded by the dp rank, not the global
rank, so both draw as one process does, and the run is held to the
one-process tuner on the same data:

- an epoch with ``accum_steps="auto"`` (the factor agreed over the whole
  group) writing the sharded full state (each rank's shares, the split
  recorded), its train losses within 1e-5 relative of the one process's;
- ``valid_evaluation`` of 5 rows at batch 4, the one-process scalar;
- a second tuner resumed from that directory under the same mesh, an epoch
  writing the ``.npz`` full state of the gathered tree (rank 0 alone logs
  and writes): its parameters within 2 lr a step of the one process's (a
  first-order AdamW step moves an element by about lr, in the direction of
  its grad's sign, which may flip where a grad is at rounding level), its
  step count and optimizer count the one process's.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save
from plip_tpu_torch.data.datasets import ImageCaptionDataset
from plip_tpu_torch.data.loader import PrefetchLoader
from plip_tpu_torch.train import clip_tuner as ct
from plip_tpu_torch.utils.checkpoint import load_checkpoint

from test_torch_parallel import spawn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR, STEPS = 1e-4, 4  # two tuners, an epoch of 2 steps each

_CHILD = r"""
import json, os
from types import SimpleNamespace
import numpy as np
import plip_tpu_torch.train.clip_tuner as ct
from plip_tpu_torch.data.datasets import ImageCaptionDataset
from plip_tpu_torch.data.loader import PrefetchLoader
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import create_mesh

rank, d = int(os.environ["_RANK"]), os.environ["_DIR"]
assert distributed.initialize(os.environ["_COORD"], 2, rank, timeout_s=120)
mesh = create_mesh(dp=1, tp=2)
data = json.load(open(os.path.join(d, "data.json")))
records = []
log = SimpleNamespace(info=lambda m, *a: records.append(m %% a if a else m),
                      warning=lambda m, *a: records.append(m %% a if a else m))


def tuner(**kw):
    return ct.CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224),
                        backbone=os.path.join(d, "tiny.npz"), lr=%(lr)r, warmup=2,
                        device="cpu", mesh=mesh, logging=log, **kw)


out = os.path.join(d, "tp")
t = tuner(accum_steps="auto")
t.tuner(data["train"], data["valid"], save_directory=out, batch_size=4, epochs=1,
        evaluation_steps=0, num_workers=2, start_time="aa", save_full_state="orbax")
v = t.valid_evaluation(PrefetchLoader(ImageCaptionDataset(data["valid5"]), 4, num_workers=2))
t2 = tuner()
t2.tuner(data["train"], data["valid"], save_directory=out, batch_size=4, epochs=1,
         evaluation_steps=0, num_workers=2, start_time="bb", save_full_state=True,
         resume_from=os.path.join(out, "epoch_0_aa_model.orbax"))
print("RESULT " + json.dumps({"rank": rank, "records": records, "v": v,
                              "resumed": [t2.state.step, t2.state.opt_state.count]}))
""" % {"lr": LR}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_tuner")
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
def tp_run(data):
    results = {}
    for rc, out, err in spawn(_CHILD, data):
        assert rc == 0, f"child failed:\n{out}\n{err[-4000:]}"
        r = json.loads([line for line in out.splitlines() if line.startswith("RESULT ")][0][7:])
        results[r["rank"]] = r
    return results


@pytest.fixture(scope="module")
def one_run(data):
    """The same two tuners in one process, without a mesh."""
    spec = json.load(open(data / "data.json"))
    records = []
    log = SimpleNamespace(info=lambda m, *a: records.append(m % a if a else m),
                          warning=lambda m, *a: records.append(m % a if a else m))

    def tuner(**kw):
        return ct.CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224),
                            backbone=str(data / "tiny.npz"), lr=LR, warmup=2, device="cpu",
                            logging=log, **kw)

    out = str(data / "one")
    t = tuner(accum_steps="auto")
    t.tuner(spec["train"], spec["valid"], save_directory=out, batch_size=4, epochs=1,
            evaluation_steps=0, num_workers=2, start_time="aa", save_full_state="orbax")
    v = t.valid_evaluation(PrefetchLoader(ImageCaptionDataset(spec["valid5"]), 4,
                                          num_workers=2))
    t2 = tuner()
    t2.tuner(spec["train"], spec["valid"], save_directory=out, batch_size=4, epochs=1,
             evaluation_steps=0, num_workers=2, start_time="bb", save_full_state=True,
             resume_from=os.path.join(out, "epoch_0_aa_model.orbax"))
    return {"records": records, "v": v, "resumed": [t2.state.step, t2.state.opt_state.count]}


def _losses(records):
    return [float(m.rsplit("loss: ", 1)[1]) for m in records if "[Train - this batch]" in m]


def test_tp_tuner_losses_match_one_process(tp_run, one_run):
    want = _losses(one_run["records"])
    assert len(want) == STEPS
    np.testing.assert_allclose(_losses(tp_run[0]["records"]), want, rtol=1e-5)
    assert _losses(tp_run[1]["records"]) == []  # rank 0 alone logs


def test_tp_valid_evaluation_gives_the_one_process_scalar(tp_run, one_run):
    for r in tp_run.values():
        assert r["v"] == pytest.approx(one_run["v"], rel=1e-5)


def test_tp_tuner_resumes_its_shards_and_writes_the_gathered_tree(data, tp_run, one_run):
    for r in tp_run.values():
        assert r["resumed"] == one_run["resumed"] == [STEPS, STEPS]
    orbax = data / "tp" / "epoch_0_aa_model.orbax"
    assert json.load(open(orbax / "tp_split.json")) == {"tp": 2}
    assert sorted(os.listdir(data / "tp")) == sorted(os.listdir(data / "one"))
    got, _ = load_checkpoint(str(data / "tp" / "epoch_0_bb_model.npz"))
    want, _ = load_checkpoint(str(data / "one" / "epoch_0_bb_model.npz"))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (got[k] - want[k]).abs().max() <= 2 * LR * STEPS, k
    # the optimizer state of the gathered tree: the one process's leaves and shapes
    a = np.load(data / "tp" / "epoch_0_bb_model.npz.opt.npz")
    b = np.load(data / "one" / "epoch_0_bb_model.npz.opt.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert a[f].shape == b[f].shape, f
