"""Data parallelism on ``torch.distributed``: two processes on the CPU (gloo).

One spawn of two processes (``initialize`` at a local address, a dp=2
mesh) runs every case below and writes each rank's results; the tests hold
them to one process of the port and to the JAX package:

- (i) a dp=2 ``make_train_step`` (single pass and ``accum_steps=2``) equals
  the one-process step on the same global batch: loss rtol 1e-5, every
  parameter leaf rtol 1e-4 and atol 1e-5 (the bars of
  ``tests/test_parallel_training.py::test_dp_sharded_step_matches_single_device``),
  the key biases excepted, whose grad is zero up to rounding, so that a
  first AdamW step moves them by up to lr (as ``test_torch_train`` bounds
  them); and the first moments, ``0.1 * grad``, rtol 1e-4 and atol 1e-8,
  which see a gradient off by a factor (AdamW's update does not); and that
  one-process step is held to the JAX step;
- (ii) ``PLIP(mesh=)`` encode and ``embed_wsi``/``embed_wsi_pyramid(mesh=)``
  equal the meshless rows, and the JAX ``PLIP``'s, with a batch that dp does
  not divide and a last batch of which one rank holds no row;
- (iii) dp fp32 and int8 retrieval, ``ops.retrieval`` and
  ``PLIP.retrieval(backend="device")``, equal the host top-k over 1,001 rows;
- (vii) the sharded full state: saved by both ranks, resumed bit for bit,
  exported by ``export_checkpoint``; a JAX orbax directory is refused;
- the ranks agree with each other, and the tensor-parallel refusals that stay
  raise: a tp mesh without its process group, and a tp that does not divide a
  tower's heads.

Single-process cases: ``create_mesh`` validation, ``initialize()`` with no
environment, and every consumer's refusal of a tp mesh without its group.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu.train import contrastive as jc
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import Mesh, check_mesh, create_mesh
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import load_any_checkpoint, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["benign", "malignant tumor", "an H&E image of stroma", "mucosa", "debris"]
LR = 1e-4
SPAWN_TIMEOUT_S = 240  # a bound for a hang; the spawn takes about 30 s alone


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(child: str, workdir, n: int = 2, timeout: float = SPAWN_TIMEOUT_S, env=None):
    """Run ``child`` in ``n`` processes (``_RANK``, ``_COORD``, ``_DIR`` in
    their environment); returns [(returncode, stdout, stderr)] by rank."""
    coord = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(n):
        e = dict(os.environ, PYTHONPATH=ROOT, _RANK=str(rank), _COORD=coord,
                 _DIR=str(workdir), OMP_NUM_THREADS="2", **(env or {}))
        e.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", child], env=e, cwd=ROOT,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    return outs


_CHILD = r"""
import os
import numpy as np
import torch
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.data.wsi import embed_wsi, embed_wsi_pyramid
from plip_tpu_torch.ops.retrieval import cosine_topk, cosine_topk_int8, quantize_rows
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import create_mesh, shard_batch
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import load_any_checkpoint

rank, d = int(os.environ["_RANK"]), os.environ["_DIR"]
assert distributed.initialize(os.environ["_COORD"], 2, rank, timeout_s=60)
mesh = create_mesh(dp=2)
assert mesh.shape == {"dp": 2, "tp": 1} and distributed.world_size() == 2
out = {}

# (i) the dp=2 train step, single pass and two-pass accumulation
b = np.load(os.path.join(d, "batch.npz"))
for accum in (1, 2):
    model, cfg = load_any_checkpoint(os.path.join(d, "train.npz"))
    opt = tc.make_optimizer(%(lr)r, warmup=2, total_steps=10)
    step = tc.make_train_step(cfg, opt, accum_steps=accum, mesh=mesh)
    state = tc.init_train_state(model, opt)
    px, ids = shard_batch((torch.from_numpy(b["px"]), torch.from_numpy(b["ids"]).long()),
                          mesh)
    assert px.shape[0] == 4
    state, m = step(state, px, ids)
    out[f"loss{accum}"] = float(m["loss"])
    for k, p in model.named_parameters():
        out[f"p{accum}|{k}"] = p.detach().numpy().copy()
        out[f"mu{accum}|{k}"] = state.opt_state.mu[k].numpy().copy()

# (vii) the sharded full state of the accumulated step, resumed bit for bit
full = os.path.join(d, "full.orbax")
tc.save_train_state_sharded(full, state, cfg)
back, _ = tc.load_train_state_sharded(full, opt)
same = [torch.equal(a, b_) for a, b_ in zip(state.model.parameters(), back.model.parameters())]
for k in state.opt_state.mu:
    same += [torch.equal(state.opt_state.mu[k], back.opt_state.mu[k]),
             torch.equal(state.opt_state.nu[k], back.opt_state.nu[k])]
out["resumed_exactly"] = all(same) and (back.step, back.opt_state.count) == (1, 1)

# (ii) encode under the mesh, and the WSI streams
srv = np.load(os.path.join(d, "serve.npz"))
plip = PLIP(os.path.join(d, "serve_ckpt.npz"), device="cpu", mesh=mesh)
out["img"] = plip.encode_images(list(srv["images"]), batch_size=3)
out["txt"] = plip.encode_text(%(prompts)r, batch_size=2)
out["wsi"], out["wsi_coords"] = embed_wsi(plip, srv["slide"], batch_size=5, mesh=mesh)
out["pyr"], out["pyr_coords"] = embed_wsi_pyramid(plip, srv["slide"], (1, 2),
                                                  batch_size=3, non_bg_threshold=0.3,
                                                  mesh=mesh)

# (iii) retrieval under the mesh
r = np.load(os.path.join(d, "retrieval.npz"))
out["f32_i"], out["f32_v"] = cosine_topk(r["q"], r["x"], k=5, chunk=64, mesh=mesh)
q8, inv = quantize_rows(r["x"])
xn = r["x"] / np.linalg.norm(r["x"], axis=1, keepdims=True)
out["i8_i"], out["i8_v"] = cosine_topk_int8(r["q"], q8, inv, k=5, chunk=64,
                                            rescore_vectors=xn, mesh=mesh)
out["i8raw_i"], _ = cosine_topk_int8(r["q"], torch.from_numpy(q8), inv, k=5, chunk=64,
                                     mesh=mesh)
for quant in (False, "int8"):
    plip.set_image_index(r["x"], quantize=quant)
    out[f"api_{quant}_dev"] = plip.retrieval(%(prompts)r, top_k=5, backend="device")
    out[f"api_{quant}_host"] = plip.retrieval(%(prompts)r, top_k=5, backend="host")

# the tensor-parallel refusals that stay: a tp mesh without its group (a
# hand-made dp=2 x tp=2 mesh over two processes), and tp not dividing heads
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu_torch.parallel.mesh import Mesh, shard_params
try:
    PLIP(os.path.join(d, "serve_ckpt.npz"), device="cpu", mesh=Mesh({"dp": 2, "tp": 2}))
except ValueError as e:
    out["tp_refusal"] = str(e)
odd = CLIPConfig(vision=VisionConfig(width=48, layers=1, heads=3, image_size=32, patch_size=16),
                 text=TextConfig(width=32, layers=1, heads=2, vocab_size=64, context_length=8),
                 embed_dim=8)
try:
    shard_params(CLIP(odd), create_mesh(dp=1, tp=2))
except ValueError as e:
    out["heads_refusal"] = str(e)
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print("CHILD DONE", rank)
""" % {"lr": LR, "prompts": PROMPTS}


def _tiny_train(m):
    return m.CLIPConfig(
        vision=m.VisionConfig(width=32, layers=2, heads=2, image_size=32, patch_size=16),
        text=m.TextConfig(width=32, layers=2, heads=2, vocab_size=128, context_length=16),
        embed_dim=16)


def _batch(cfg, B=8, seed=3):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((B, cfg.vision.image_size, cfg.vision.image_size, 3))
    ids = np.zeros((B, cfg.text.context_length), np.int32)
    ids[:, 0] = 1
    ids[:, 1:4] = rng.integers(2, 120, (B, 3))
    ids[:, 4] = cfg.text.eot
    return px.astype(np.float32), ids


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp2")
    jcfg = _tiny_train(jconfig)
    jax_save(str(d / "train.npz"), jax.device_get(jclip.init_params(jax.random.PRNGKey(1),
                                                                     jcfg)), jcfg)
    px, ids = _batch(jcfg)
    np.savez(d / "batch.npz", px=px, ids=ids)
    scfg = jconfig.CLIPConfig(
        vision=jconfig.VisionConfig(width=64, layers=2, heads=4, image_size=224,
                                    patch_size=32),
        text=jconfig.TextConfig(width=32, layers=2, heads=4, vocab_size=49408,
                                context_length=77),
        embed_dim=16)
    jax_save(str(d / "serve_ckpt.npz"), jclip.init_params(jax.random.PRNGKey(7), scfg), scfg)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (7, 240, 256, 3), dtype=np.uint8)
    slide = rng.integers(40, 180, (500, 700, 3), dtype=np.uint8)
    slide[:, 560:] = 255
    np.savez(d / "serve.npz", images=images, slide=slide)
    x = rng.standard_normal((1001, 16)).astype(np.float32)
    x[500] = x[17]  # an exact tie across the two shards
    np.savez(d / "retrieval.npz", x=x, q=rng.standard_normal((3, 16)).astype(np.float32))
    outs = spawn(_CHILD, d)
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\n{out}\n{err[-4000:]}"
    return d, [dict(np.load(d / f"out{r}.npz")) for r in range(2)]


def _one_process_step(d, accum):
    model, cfg = load_any_checkpoint(str(d / "train.npz"))
    opt = tc.make_optimizer(LR, warmup=2, total_steps=10)
    state = tc.init_train_state(model, opt)
    b = np.load(d / "batch.npz")
    state, m = tc.make_train_step(cfg, opt, accum_steps=accum)(
        state, torch.from_numpy(b["px"]), torch.from_numpy(b["ids"]).long())
    return float(m["loss"]), state, cfg


def _is_key_bias(name, cfg):
    return name.endswith("attn.qkv.bias")


def _key_part(name, a, cfg):
    w = cfg.vision.width if name.startswith("visual") else cfg.text.width
    return a[..., w:2 * w]


@pytest.mark.parametrize("accum", [1, 2])
def test_dp2_step_matches_one_process(dp2, accum):
    d, outs = dp2
    loss, state, cfg = _one_process_step(d, accum)
    for out in outs:
        assert out[f"loss{accum}"] == pytest.approx(loss, rel=1e-5)
        for k, p in state.model.named_parameters():
            got, want = out[f"p{accum}|{k}"], p.detach().numpy()
            if _is_key_bias(k, cfg):
                kg, kw = _key_part(k, got, cfg), _key_part(k, want, cfg)
                assert np.abs(kg - kw).max() <= 2 * LR, k
                got, want = got.copy(), want.copy()
                _key_part(k, got, cfg)[...] = 0
                _key_part(k, want, cfg)[...] = 0
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(out[f"mu{accum}|{k}"], state.opt_state.mu[k].numpy(),
                                       rtol=1e-4, atol=1e-8, err_msg=k)


def test_one_process_step_matches_jax(dp2):
    """The reference of the dp test: one port step against one JAX step on
    the same parameters and batch (``test_torch_train``'s bars)."""
    d, _ = dp2
    loss, state, cfg = _one_process_step(d, 1)
    from plip_tpu.utils.checkpoint import load_checkpoint

    params, jcfg = load_checkpoint(str(d / "train.npz"))
    b = np.load(d / "batch.npz")
    jopt = jc.make_optimizer(LR, warmup=2, total_steps=10)
    jstate = jc.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    jstate, jm = jc.make_train_step(jcfg, jopt)(jstate, jnp.asarray(b["px"]),
                                               jnp.asarray(b["ids"]))
    assert loss == pytest.approx(float(jm["loss"]), rel=2e-5)
    got = to_jax_params(state.model, cfg)
    want = jax.device_get(jstate.params)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        if "qkv" in jax.tree_util.keystr(path) and "bias" in jax.tree_util.keystr(path):
            width = cfg.vision.width if path[0].key == "visual" else cfg.text.width
            assert np.abs(g[..., width:2 * width] - w[..., width:2 * width]).max() <= 2 * LR
            g, w = g.copy(), w.copy()
            g[..., width:2 * width] = w[..., width:2 * width] = 0
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=LR / 10,
                                   err_msg=jax.tree_util.keystr(path))


def _cos_close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos.min()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_mesh_encode_matches_meshless_and_jax(dp2):
    d, outs = dp2
    srv = np.load(d / "serve.npz")
    images = list(srv["images"])
    plain = PLIP(str(d / "serve_ckpt.npz"), device="cpu")
    want_img = plain.encode_images(images, batch_size=3)
    want_txt = plain.encode_text(PROMPTS, batch_size=2)
    for out in outs:
        assert out["img"].shape == (7, 16) and out["txt"].shape == (5, 16)
        np.testing.assert_allclose(out["img"], want_img, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["txt"], want_txt, rtol=1e-5, atol=1e-6)
    jm = JPLIP(str(d / "serve_ckpt.npz"))
    _cos_close(outs[0]["img"], jm.encode_images(images, batch_size=4))
    _cos_close(outs[0]["txt"], jm.encode_text(PROMPTS, batch_size=2))


def test_mesh_wsi_streams_match_meshless(dp2):
    from plip_tpu_torch.data.wsi import embed_wsi, embed_wsi_pyramid

    d, outs = dp2
    slide = np.load(d / "serve.npz")["slide"]
    plain = PLIP(str(d / "serve_ckpt.npz"), device="cpu")
    want, coords = embed_wsi(plain, slide, batch_size=5)
    pyr, pyr_coords = embed_wsi_pyramid(plain, slide, (1, 2), batch_size=3,
                                        non_bg_threshold=0.3)
    assert len(coords) == 6 and len(pyr_coords) > 3  # last batches: 1 row, so rank 1 none
    for out in outs:
        np.testing.assert_array_equal(out["wsi_coords"], coords)
        np.testing.assert_allclose(out["wsi"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out["pyr_coords"], pyr_coords)
        np.testing.assert_allclose(out["pyr"], pyr, rtol=1e-5, atol=1e-6)


def _host_topk(q, x, k):
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = q @ x.T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(s, idx, axis=1)


@pytest.mark.parametrize("case", ["f32", "i8", "i8raw"])
def test_mesh_retrieval_matches_host(dp2, case):
    d, outs = dp2
    r = np.load(d / "retrieval.npz")
    xn = r["x"] / np.linalg.norm(r["x"], axis=1, keepdims=True)
    idx, vals = _host_topk(r["q"], xn, 5)
    for out in outs:
        if case == "i8raw":  # the quantized ranking, held to the one-process stream
            from plip_tpu_torch.ops.retrieval import cosine_topk_int8, quantize_rows

            q8, inv = quantize_rows(r["x"])
            want, _ = cosine_topk_int8(r["q"], q8, inv, k=5, chunk=64)
            np.testing.assert_array_equal(out["i8raw_i"], want)
            continue
        np.testing.assert_array_equal(out[f"{case}_i"], idx)
        np.testing.assert_allclose(out[f"{case}_v"], vals, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", ["False", "int8"])
def test_mesh_api_retrieval_matches_host(dp2, quant):
    _, outs = dp2
    for out in outs:
        np.testing.assert_array_equal(out[f"api_{quant}_dev"], out[f"api_{quant}_host"])
    np.testing.assert_array_equal(outs[0][f"api_{quant}_dev"], outs[1][f"api_{quant}_dev"])


def test_ranks_agree_and_tp_is_refused(dp2):
    _, outs = dp2
    a, b = outs
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert "process group" in str(a["tp_refusal"])
    assert "vision tower's 3 heads" in str(a["heads_refusal"])


def test_sharded_full_state_resumes_and_exports(dp2, tmp_path):
    from plip_tpu_torch.scripts.export_checkpoint import main as port_export

    d, outs = dp2
    assert bool(outs[0]["resumed_exactly"]) and bool(outs[1]["resumed_exactly"])
    full = d / "full.orbax"
    assert {"__0_0.distcp", "__1_0.distcp", ".metadata", "clip_config.json"} <= set(
        os.listdir(full))
    state, cfg = tc.load_train_state_sharded(str(full), tc.make_optimizer())  # one process
    for k, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), outs[0][f"p2|{k}"], err_msg=k)
    path = port_export([str(full), str(tmp_path / "out.pt"), "--device", "cpu"])
    exported, _ = load_any_checkpoint(path)
    for k, p in exported.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), outs[0][f"p2|{k}"], err_msg=k)


def test_a_jax_orbax_directory_is_refused(tmp_path):
    """The JAX package's orbax full state (which imports JAX) is refused,
    with the way across: the ``.npz`` full state both packages read."""
    pytest.importorskip("orbax.checkpoint")
    cfg = _tiny_train(jconfig)
    opt = jc.make_optimizer(LR, warmup=2, total_steps=10)
    state = jc.init_train_state(jclip.init_params(jax.random.PRNGKey(0), cfg), opt)
    path = str(tmp_path / "jax.orbax")
    jc.save_train_state_orbax(path, state, cfg)
    with pytest.raises(ValueError, match="orbax.*save_full_state=True"):
        tc.load_train_state_sharded(path, tc.make_optimizer())
    from plip_tpu_torch.scripts.export_checkpoint import main as port_export

    with pytest.raises(ValueError, match="npz"):
        port_export([path, str(tmp_path / "x.pt"), "--device", "cpu"])


def test_create_mesh_validation():
    assert create_mesh().shape == {"dp": 1, "tp": 1}
    assert create_mesh(dp=1).shape == {"dp": 1, "tp": 1}
    for dp, tp in ((3, 3), (2, 1), (1, 2), (0, 1), (None, 0)):
        with pytest.raises(ValueError):
            create_mesh(dp=dp, tp=tp)


def test_initialize_without_an_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.agree_max_int(7) == 7
    assert distributed.local_batch_slice(8) == slice(0, 8)
    host = tc.gather_to_host({"a": torch.ones(2), "b": {"c": torch.zeros(1)}})
    assert host["a"].tolist() == [1.0, 1.0] and host["b"]["c"].tolist() == [0.0]
    with pytest.raises(ValueError):
        distributed.initialize("127.0.0.1:1")  # an address needs the count and rank


def test_tp_is_refused_by_every_consumer(tmp_path):
    from plip_tpu_torch.data.wsi import embed_wsi
    from plip_tpu_torch.ops.retrieval import cosine_topk
    from plip_tpu_torch.train.clip_tuner import CLIPTuner

    tp = Mesh({"dp": 1, "tp": 2})
    calls = [lambda: PLIP("random:ViT-B/32", device="cpu", mesh=tp),
             lambda: CLIPTuner(model_type="ViT-B/32", device="cpu", mesh=tp),
             lambda: tc.make_train_step(tconfig_b32(), tc.make_optimizer(), mesh=tp),
             lambda: cosine_topk(np.ones((1, 4)), np.ones((3, 4)), k=1, mesh=tp),
             lambda: embed_wsi(SimplePLIP(), np.zeros((224, 224, 3), np.uint8), mesh=tp),
             lambda: check_mesh(tp, "x")]
    for call in calls:
        with pytest.raises(ValueError, match="process group"):
            call()


def tconfig_b32():
    from plip_tpu_torch.models.config import CLIPConfig

    return CLIPConfig.vit_b32()


class SimplePLIP:
    device = torch.device("cpu")
