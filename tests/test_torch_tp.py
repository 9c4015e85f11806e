"""Tensor parallelism on ``torch.distributed``: processes on the CPU (gloo).

Two module-scoped spawns run every multi-process case and write each rank's
results; the tests hold them to one process of the port and to the JAX
package's ``create_mesh(dp=4, tp=2)`` with ``shard_params`` on the eight
virtual CPU devices (``tests/conftest.py``):

- ``tp2``: two processes, a ``tp=2`` mesh. Train steps under remat False,
  ``"mlp"``, ``"block"``, ``"mlp_h1"`` and True, ``BWD_MODE="dwsplit"``, and
  the wide towers' paths (the hybrid, the composed sublayer over K3 and its
  K4 backward, the composed block) reached by lowering the path's width and
  length thresholds; a step at an uneven vocabulary (127 over 2 ranks); the
  gathered grads (rtol 1e-4, atol 1e-5), first moments (``0.1 grad``: rtol
  1e-4, atol 1e-6, the grads' bar scaled; the tp forward's partial sums
  move some 40 of 100k cancelled elements by up to 5e-7, past the dp
  test's 1e-8), parameters (within 2 lr: a first AdamW step moves an element by
  about lr times the sign of its grad, which may flip where a grad is at
  rounding level, as the key biases') and loss (rtol 1e-5) against one
  process; ``PLIP(mesh=)`` encodes (rtol 1e-4, atol 1e-5) and its gathered
  ``save``; W8A8 at width 1024: every int8 product's int32 sums equal the
  one process's (this rank's columns of qkv and fc1, the whole sums of out
  and fc2); K10's entry point (``ops.block.transformer_block``) on the
  rank's shares.
- ``dp2tp2``: four processes, ``dp=2, tp=2`` (global rank ``d * 2 + t``).
  Steps under remat False, ``"mlp"`` and ``"block"`` and at the uneven
  vocabulary at a global batch of 8 (4 rows a dp rank), encodes of a
  batch that dp does not divide, ``embed_wsi`` and the dp retrieval
  streams, the ``.npz`` and sharded full states. These pin the faults a tp
  mesh would meet in the dp code: rows by the global rank (``local_rows``,
  ``shard_batch``: the encodes and the steps), a broadcast from global rank
  0 over the whole group (``replicate_params``: rank 1's shares would
  become rank 0's), and the gradient sum and the embedding gather over the
  whole group (``_all_reduce_grads_``: the first moments would double;
  ``gather_with_grad``: the loss would see every row twice).

Single-process cases: ``shard_tensor`` / ``gather_tensor`` round trips bit
for bit (ViT-B/32 and tiny trees), rank t's qkv columns are its heads' q, k
and v, the uneven vocabulary shard and its masked lookup, the two epilogue
orders, and the refusal of a tp that does not divide a tower's heads.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu.parallel import mesh as jmesh
from plip_tpu.train import contrastive as jc
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.models.config import ARCHITECTURES
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import tp as TP
from plip_tpu_torch.parallel.distributed import TPGroup
from plip_tpu_torch.parallel.mesh import (Mesh, check_heads, gather_tensor, param_spec,
                                          shard_params, shard_tensor, vocab_shard)
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import load_any_checkpoint

from test_torch_parallel import PROMPTS, _batch, _cos_close, _tiny_train, spawn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHILD_THREADS = "2"  # OMP_NUM_THREADS of test_torch_parallel.spawn's children

LR = 1e-4
# (name, remat, the wide towers' paths, BWD_MODE, checkpoint)
CASES = (("False", False, False, "fused", "train"),
         ("mlp", "mlp", False, "fused", "train"),
         ("block", "block", False, "fused", "train"),
         ("mlp_h1", "mlp_h1", False, "fused", "train"),
         ("True", True, False, "fused", "train"),
         ("dwsplit", "mlp", False, "dwsplit", "train"),
         ("wide_False", False, True, "fused", "train"),
         ("wide_mlp", "mlp", True, "fused", "train"),
         ("wide_block", "block", True, "fused", "train"),
         ("uneven", "mlp", False, "fused", "uneven"))
STEP_CASES = [c[0] for c in CASES]
# the four-process spawn's: the remats the dp repairs meet, and the uneven
# vocabulary (the last, whose state the full-state cases save)
DP_STEP_CASES = ["False", "mlp", "block", "uneven"]

_CHILD = r"""
import os
import numpy as np
import torch
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.data.wsi import embed_wsi
from plip_tpu_torch.models import layers
from plip_tpu_torch.ops import attention as A
from plip_tpu_torch.ops import quant
from plip_tpu_torch.ops.retrieval import cosine_topk, cosine_topk_int8, quantize_rows
from plip_tpu_torch.parallel import distributed
from plip_tpu_torch.parallel.mesh import (create_mesh, gather_tree, param_spec, shard_batch,
                                          shard_params, shard_tensor)
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import load_any_checkpoint

rank, dp, tp, d = (int(os.environ["_RANK"]), int(os.environ["_DP"]), int(os.environ["_TP"]),
                   os.environ["_DIR"])
assert distributed.initialize(os.environ["_COORD"], dp * tp, rank, timeout_s=120)
mesh = create_mesh(dp=dp, tp=tp)
assert (mesh.dp_rank, mesh.tp_rank) == divmod(rank, tp)
out = {}
for name, remat, wide, mode, ckpt in %(cases)r:
    if dp > 1 and name not in %(dp_cases)r:
        continue
    b = np.load(os.path.join(d, f"batch_{ckpt}.npz"))
    A.BWD_MODE = mode
    layers.FLAT_FWD_ONLY_MAX_W, layers.SHORT_SEQ = (16, 2) if wide else (768, 128)
    model, cfg = load_any_checkpoint(os.path.join(d, ckpt + ".npz"))
    shard_params(model, mesh)
    opt = tc.make_optimizer(%(lr)r, warmup=2, total_steps=10)
    state = tc.init_train_state(model, opt)
    px, ids = shard_batch((torch.from_numpy(b["px"]), torch.from_numpy(b["ids"]).long()), mesh)
    if dp == 1:  # the whole batch on every rank: its local grads are the grads
        loss, _ = tc.clip_loss(model, px, ids, torch.float32, remat, mesh)
        loss.backward()
        grads = gather_tree({k: p.grad for k, p in model.named_parameters()}, mesh)
        for k, g in grads.items():
            out[f"{name}|g|{k}"] = g.numpy()
        model.zero_grad(set_to_none=True)
    state, m = tc.make_train_step(cfg, opt, remat=remat, mesh=mesh)(state, px, ids)
    out[f"{name}|loss"] = float(m["loss"])
    held = dict(model.named_parameters())
    full = gather_tree(held, mesh)
    # each rank holds its share: 1/tp of a split leaf, its ceil share of the vocabulary
    out[f"{name}|held"] = [held[k].numel() == shard_tensor(full[k], param_spec(k), mesh.tp_rank,
                                                          tp).numel() < full[k].numel()
                           for k in held if param_spec(k) is not None]
    for k, v in full.items():
        out[f"{name}|p|{k}"] = v.detach().numpy()
    for k, v in gather_tree(state.opt_state.mu, mesh).items():
        out[f"{name}|mu|{k}"] = v.numpy()
A.BWD_MODE = "fused"
layers.FLAT_FWD_ONLY_MAX_W, layers.SHORT_SEQ = 768, 128

srv = np.load(os.path.join(d, "serve.npz"))
plip = PLIP(os.path.join(d, "serve_ckpt.npz"), device="cpu", mesh=mesh)
out["img"] = plip.encode_images(list(srv["images"]), batch_size=3)
out["txt"] = plip.encode_text(%(prompts)r, batch_size=2)
plip.save(os.path.join(d, f"saved{dp}{tp}_{rank}.npz"))

if dp == 1:  # W8A8 at width 1024: the int32 sums of every int8 product
    real, sums = quant.w8a8_accumulate, []

    def spy(x, p, tp=None):
        acc, ascale = real(x, p, tp)
        sums.append(acc.numpy().copy())
        return acc, ascale

    quant.w8a8_accumulate = spy
    wide = PLIP(os.path.join(d, "w1024.npz"), device="cpu", quantize="w8a8", mesh=mesh)
    out["w8a8"] = wide.encode_images(list(srv["images"][:2]), batch_size=2)
    quant.w8a8_accumulate = real
    for i, s in enumerate(sums):
        out[f"w8a8_sum|{i}"] = s
    # K10 (ops.block.transformer_block, an entry point): forward and grads
    from plip_tpu_torch.ops.block import transformer_block

    model, cfg = load_any_checkpoint(os.path.join(d, "train.npz"))
    blk = shard_params(model, mesh).visual.blocks[0]
    x = torch.from_numpy(np.load(os.path.join(d, "block_x.npz"))["x"]).requires_grad_()
    y = transformer_block(x, {"ln1": blk.ln1, "attn": blk.attn, "ln2": blk.ln2,
                              "mlp": blk.mlp}, blk.local_heads, False, cfg.ln_eps, blk.tp)
    y.backward(torch.cos(y.detach()))
    out["k10_y"], out["k10_dx"] = y.detach().numpy(), x.grad.numpy()
    grads = {"visual.blocks.0." + k: t.grad for k, t in blk.named_parameters()}
    for k, v in gather_tree(grads, mesh).items():
        out[f"k10_g|{k}"] = v.numpy()
else:  # the dp streams, and the full states
    out["wsi"], out["wsi_coords"] = embed_wsi(plip, srv["slide"], batch_size=5, mesh=mesh)
    r = np.load(os.path.join(d, "retrieval.npz"))
    out["f32_i"], _ = cosine_topk(r["q"], r["x"], k=5, chunk=64, mesh=mesh)
    q8, inv = quantize_rows(r["x"])
    out["i8_i"], _ = cosine_topk_int8(r["q"], q8, inv, k=5, chunk=64, mesh=mesh)
    full_path = os.path.join(d, "full.orbax")
    tc.save_train_state_sharded(full_path, state, cfg, mesh)
    back, _ = tc.load_train_state_sharded(full_path, opt, mesh=mesh)
    same = [torch.equal(a, b_) for a, b_ in zip(state.model.parameters(),
                                                back.model.parameters())]
    same += [torch.equal(state.opt_state.mu[k], back.opt_state.mu[k])
             and torch.equal(state.opt_state.nu[k], back.opt_state.nu[k])
             for k in state.opt_state.mu]
    out["resumed_exactly"] = all(same) and (back.step, back.opt_state.count) == (1, 1)
    tc.save_train_state(os.path.join(d, "full_state.npz"), state, cfg, mesh)
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print("CHILD DONE", rank)
""" % {"cases": CASES, "dp_cases": DP_STEP_CASES, "lr": LR, "prompts": PROMPTS}



def _uneven(m):
    cfg = _tiny_train(m)
    return m.CLIPConfig(vision=cfg.vision,
                        text=m.TextConfig(width=32, layers=2, heads=2, vocab_size=127,
                                          context_length=16), embed_dim=16)


def _prepare(d):
    jcfg = _tiny_train(jconfig)
    jax_save(str(d / "train.npz"), jax.device_get(jclip.init_params(jax.random.PRNGKey(1),
                                                                     jcfg)), jcfg)
    ucfg = _uneven(jconfig)
    jax_save(str(d / "uneven.npz"), jax.device_get(jclip.init_params(jax.random.PRNGKey(2),
                                                                      ucfg)), ucfg)
    for name, cfg in (("train", jcfg), ("uneven", ucfg)):
        px, ids = _batch(cfg)
        np.savez(d / f"batch_{name}.npz", px=px, ids=ids)
    scfg = jconfig.CLIPConfig(
        vision=jconfig.VisionConfig(width=64, layers=2, heads=4, image_size=224,
                                    patch_size=32),
        text=jconfig.TextConfig(width=32, layers=2, heads=4, vocab_size=49408,
                                context_length=77),
        embed_dim=16)
    jax_save(str(d / "serve_ckpt.npz"), jclip.init_params(jax.random.PRNGKey(7), scfg), scfg)
    wcfg = jconfig.CLIPConfig(
        vision=jconfig.VisionConfig(width=1024, layers=1, heads=16, image_size=224,
                                    patch_size=32),
        text=jconfig.TextConfig(width=32, layers=1, heads=2, vocab_size=49408,
                                context_length=77),
        embed_dim=16)
    jax_save(str(d / "w1024.npz"), jclip.init_params(jax.random.PRNGKey(5), wcfg), wcfg)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (7, 240, 256, 3), dtype=np.uint8)
    slide = rng.integers(40, 180, (500, 700, 3), dtype=np.uint8)
    slide[:, 560:] = 255
    np.savez(d / "serve.npz", images=images, slide=slide)
    x = rng.standard_normal((1001, 16)).astype(np.float32)
    np.savez(d / "retrieval.npz", x=x, q=rng.standard_normal((3, 16)).astype(np.float32))
    np.savez(d / "block_x.npz", x=rng.standard_normal((2, 5, 32)).astype(np.float32))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    _prepare(d)
    return d


def _run(d, dp, tp):
    for rc, out, err in spawn(_CHILD, d, n=dp * tp,
                              env={"_DP": str(dp), "_TP": str(tp)}):
        assert rc == 0, f"child failed:\n{out}\n{err[-4000:]}"
    return [dict(np.load(d / f"out{r}.npz")) for r in range(dp * tp)]


@pytest.fixture(scope="module")
def tp2(ckpts):
    return _run(ckpts, 1, 2)


@pytest.fixture(scope="module")
def dp2tp2(ckpts, tp2):  # after tp2: the spawns share the directory
    return _run(ckpts, 2, 2)


@pytest.fixture(scope="module")
def meshless(ckpts):
    return _meshless(ckpts)


def _meshless(d):
    """The one-process port on the same checkpoints and batch: every case's
    loss, grads, parameters and first moments."""
    out = {}
    try:
        for name, remat, wide, mode, ckpt in CASES:
            b = np.load(d / f"batch_{ckpt}.npz")
            px, ids = torch.from_numpy(b["px"]), torch.from_numpy(b["ids"]).long()
            T.BWD_MODE = mode
            tlayers.FLAT_FWD_ONLY_MAX_W, tlayers.SHORT_SEQ = (16, 2) if wide else (768, 128)
            model, cfg = load_any_checkpoint(str(d / f"{ckpt}.npz"))
            opt = tc.make_optimizer(LR, warmup=2, total_steps=10)
            state = tc.init_train_state(model, opt)
            loss, _ = tc.clip_loss(model, px, ids, torch.float32, remat)
            loss.backward()
            out[name, "g"] = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            state, m = tc.make_train_step(cfg, opt, remat=remat)(state, px, ids)
            out[name, "loss"] = float(m["loss"])
            out[name, "p"] = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
            out[name, "mu"] = {k: v.numpy().copy() for k, v in state.opt_state.mu.items()}
    finally:
        T.BWD_MODE = "fused"
        tlayers.FLAT_FWD_ONLY_MAX_W, tlayers.SHORT_SEQ = 768, 128
    return out


def _hold_step(out, want, name, grads):
    assert out[f"{name}|loss"] == pytest.approx(want[name, "loss"], rel=1e-5)
    assert all(out[f"{name}|held"]) and len(out[f"{name}|held"]) > 0
    for k, p in want[name, "p"].items():
        got = out[f"{name}|p|{k}"]
        assert got.shape == p.shape, k
        assert np.abs(got - p).max() <= 2 * LR, k
        # a first moment is 0.1 grad: the grads' bar, scaled (module doc)
        np.testing.assert_allclose(out[f"{name}|mu|{k}"], want[name, "mu"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        if grads:
            np.testing.assert_allclose(out[f"{name}|g|{k}"], want[name, "g"][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", STEP_CASES)
def test_tp2_step_matches_one_process(tp2, meshless, name):
    for out in tp2:
        _hold_step(out, meshless, name, grads=True)


@pytest.mark.parametrize("name", DP_STEP_CASES)
def test_dp2tp2_step_matches_one_process(dp2tp2, meshless, name):
    for out in dp2tp2:
        _hold_step(out, meshless, name, grads=False)


@pytest.mark.parametrize("mesh_name", ["tp2", "dp2tp2"])
def test_ranks_agree(request, mesh_name):
    outs = request.getfixturevalue(mesh_name)
    for out in outs[1:]:
        for k, v in outs[0].items():
            # a dp rank's local grads are its rows', a tp rank's W8A8 sums its shares
            if "|g|" not in k and not k.startswith("w8a8_sum"):
                np.testing.assert_array_equal(out[k], v, err_msg=k)


@pytest.mark.parametrize("mesh_name", ["tp2", "dp2tp2"])
def test_mesh_encode_matches_meshless_and_jax(request, ckpts, mesh_name):
    outs = request.getfixturevalue(mesh_name)
    srv = np.load(ckpts / "serve.npz")
    images = list(srv["images"])
    plain = PLIP(str(ckpts / "serve_ckpt.npz"), device="cpu")
    want_img = plain.encode_images(images, batch_size=3)
    want_txt = plain.encode_text(PROMPTS, batch_size=2)
    for out in outs:
        np.testing.assert_allclose(out["img"], want_img, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["txt"], want_txt, rtol=1e-4, atol=1e-5)
    jm = JPLIP(str(ckpts / "serve_ckpt.npz"), mesh=jmesh.create_mesh(dp=4, tp=2))
    _cos_close(outs[0]["img"], jm.encode_images(images, batch_size=4))
    _cos_close(outs[0]["txt"], jm.encode_text(PROMPTS, batch_size=2))


def test_tp_step_loss_matches_the_jax_mesh(ckpts, tp2):
    """One JAX step on ``create_mesh(dp=4, tp=2)`` with ``shard_params``
    against the port's tp=2 step (remat False), at the JAX parity test's
    loss bar."""
    from plip_tpu.utils.checkpoint import load_checkpoint

    params, jcfg = load_checkpoint(str(ckpts / "train.npz"))
    b = np.load(ckpts / "batch_train.npz")
    mesh = jmesh.create_mesh(dp=4, tp=2)
    opt = jc.make_optimizer(LR, warmup=2, total_steps=10)
    state = jc.init_train_state(jmesh.shard_params(jax.tree.map(jnp.asarray, params), mesh), opt)
    bp, bi = jmesh.shard_batch((jnp.asarray(b["px"]), jnp.asarray(b["ids"])), mesh)
    _, m = jc.make_train_step(jcfg, opt)(state, bp, bi)
    assert tp2[0]["False|loss"] == pytest.approx(float(m["loss"]), rel=2e-5)


@pytest.mark.parametrize("mesh_name", ["tp2", "dp2tp2"])
def test_save_writes_the_gathered_tree(request, ckpts, mesh_name):
    outs = request.getfixturevalue(mesh_name)
    dp, tp = (1, 2) if mesh_name == "tp2" else (2, 2)
    want, _ = load_any_checkpoint(str(ckpts / "serve_ckpt.npz"))
    for r in range(len(outs)):
        got, _ = load_any_checkpoint(str(ckpts / f"saved{dp}{tp}_{r}.npz"))
        for (k, a), (k2, b) in zip(got.state_dict().items(), want.state_dict().items()):
            assert k == k2
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_w8a8_integers_at_tp2_equal_the_meshless_ones(ckpts, tp2):
    """Width 1024, one layer: the int32 sums of each int8 product (qkv, out,
    fc1, fc2 in a block's order) equal the one process's, rank t holding
    its share of the column layers' and the row layers' whole."""
    from plip_tpu_torch.ops import quant

    real, sums = quant.w8a8_accumulate, []

    def spy(x, p, tp=None):
        acc, ascale = real(x, p, tp)
        sums.append(acc.numpy().copy())
        return acc, ascale

    srv = np.load(ckpts / "serve.npz")
    wide = PLIP(str(ckpts / "w1024.npz"), device="cpu", quantize="w8a8")
    # the children's thread count: the fp32 products between the int8 ones
    # (the cores) give the same bits only at the same CPU threading
    threads = torch.get_num_threads()
    quant.w8a8_accumulate = spy
    torch.set_num_threads(int(CHILD_THREADS))
    try:
        want = wide.encode_images(list(srv["images"][:2]), batch_size=2)
    finally:
        quant.w8a8_accumulate = real
        torch.set_num_threads(threads)
    assert len(sums) == 4
    for t, out in enumerate(tp2):
        for i, full in enumerate(sums):
            spec = ("qkv", None, "col", None)[i]
            np.testing.assert_array_equal(out[f"w8a8_sum|{i}"],
                                          shard_tensor(torch.from_numpy(full), spec, t, 2),
                                          err_msg=f"product {i}")
        np.testing.assert_array_equal(out["w8a8"], want)


def test_k10_block_at_tp2_matches_meshless(ckpts, tp2):
    """``ops.block.transformer_block`` (K10's path forward, the composed
    block's autograd backward) on a rank's shares: its two sums over the
    group give the meshless output, input grad and (gathered) parameter
    grads."""
    from plip_tpu_torch.ops.block import transformer_block

    model, cfg = load_any_checkpoint(str(ckpts / "train.npz"))
    blk = model.visual.blocks[0]
    x = torch.from_numpy(np.load(ckpts / "block_x.npz")["x"]).requires_grad_()
    y = transformer_block(x, {"ln1": blk.ln1, "attn": blk.attn, "ln2": blk.ln2,
                              "mlp": blk.mlp}, blk.heads, False, cfg.ln_eps)
    y.backward(torch.cos(y.detach()))
    for out in tp2:
        np.testing.assert_allclose(out["k10_y"], y.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["k10_dx"], x.grad.numpy(), rtol=1e-4, atol=1e-5)
        for k, t in blk.named_parameters():
            np.testing.assert_allclose(out[f"k10_g|visual.blocks.0.{k}"], t.grad.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_dp2tp2_streams_match_meshless(ckpts, dp2tp2):
    from plip_tpu_torch.data.wsi import embed_wsi
    from plip_tpu_torch.ops.retrieval import cosine_topk, cosine_topk_int8, quantize_rows

    plain = PLIP(str(ckpts / "serve_ckpt.npz"), device="cpu")
    want, coords = embed_wsi(plain, np.load(ckpts / "serve.npz")["slide"], batch_size=5)
    r = np.load(ckpts / "retrieval.npz")
    f32, _ = cosine_topk(r["q"], r["x"], k=5, chunk=64)
    q8, inv = quantize_rows(r["x"])
    i8, _ = cosine_topk_int8(r["q"], q8, inv, k=5, chunk=64)
    for out in dp2tp2:
        np.testing.assert_array_equal(out["wsi_coords"], coords)
        np.testing.assert_allclose(out["wsi"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(out["f32_i"], f32)
        np.testing.assert_array_equal(out["i8_i"], i8)


def test_dp2tp2_full_states_resume_and_read_whole(ckpts, dp2tp2, tmp_path):
    """The sharded directory: each tp rank's shares under keys of their own,
    the split recorded, resumed under the same mesh bit for bit, read whole
    by one process and by ``export_checkpoint``; the ``.npz`` full state of
    the gathered tree."""
    from plip_tpu_torch.scripts.export_checkpoint import main as port_export

    assert all(bool(out["resumed_exactly"]) for out in dp2tp2)
    full = ckpts / "full.orbax"
    assert {".metadata", "clip_config.json", "tp_split.json"} <= set(os.listdir(full))
    want = {k[len("uneven|p|"):]: v for k, v in dp2tp2[0].items() if k.startswith("uneven|p|")}
    wmu = {k[len("uneven|mu|"):]: v for k, v in dp2tp2[0].items() if k.startswith("uneven|mu|")}
    state, _ = tc.load_train_state_sharded(str(full), tc.make_optimizer())
    npz, _ = tc.load_train_state(str(ckpts / "full_state.npz"), tc.make_optimizer())
    for s in (state, npz):
        assert (s.step, s.opt_state.count) == (1, 1)
        for k, p in s.model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
            np.testing.assert_array_equal(s.opt_state.mu[k].numpy(), wmu[k], err_msg=k)
    path = port_export([str(full), str(tmp_path / "out.pt"), "--device", "cpu"])
    exported, _ = load_any_checkpoint(path)
    for k, p in exported.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[k], err_msg=k)
    with pytest.raises(ValueError, match="saved under tp=2"):
        tc.load_train_state_sharded(str(full), tc.make_optimizer(),
                                    mesh=Mesh({"dp": 1, "tp": 4}))


# ---------------------------------------------------------------------------
# Single-process cases
# ---------------------------------------------------------------------------


def _round_trip(sd, tp):
    for k, v in sd.items():
        spec = param_spec(k)
        parts = [shard_tensor(v, spec, t, tp) for t in range(tp)]
        if spec is not None:
            assert sum(p.numel() for p in parts) == v.numel(), k
            if spec != "vocab":
                assert all(p.numel() * tp == v.numel() for p in parts), k
        assert torch.equal(gather_tensor(parts, spec), v), k


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_exact_at_vit_b32(tp):
    sd = CLIP(ARCHITECTURES["ViT-B/32"]()).init_params(torch.Generator().manual_seed(0))
    _round_trip(sd.state_dict(), tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_exact_at_tiny_shapes(tp):
    from plip_tpu_torch.models.config import CLIPConfig

    model = CLIP(CLIPConfig.tiny(vocab_size=67)).init_params(torch.Generator().manual_seed(1))
    _round_trip(model.state_dict(), tp)


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_t_holds_its_heads_q_k_and_v(tp):
    W, heads = 96, 8
    D, per = W // heads, heads // tp
    # column c of the fused qkv: part c // W (q, k, v), head (c % W) // D
    cols = torch.arange(3 * W).expand(W, 3 * W)
    for t in range(tp):
        got = shard_tensor(cols, "qkv", t, tp)
        want = [part * W + h * D + j for part in range(3)
                for h in range(t * per, (t + 1) * per) for j in range(D)]
        assert got[0].tolist() == want
        assert shard_tensor(cols[0], "qkv", t, tp).tolist() == want  # the bias


def test_uneven_vocabulary_shards_and_lookup():
    """127 rows over 2 ranks: 64 and 63; a rank's lookup reads zeros outside
    its rows, and the ranks' partials (summed here, where the group's
    all-reduce adds them) give the meshless rows; the gradient stays on each
    shard's rows."""
    from plip_tpu_torch.models.config import CLIPConfig

    assert [vocab_shard(127, t, 2) for t in range(2)] == [(0, 64), (64, 127)]
    assert [vocab_shard(10, t, 4) for t in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    model = CLIP(CLIPConfig.tiny(vocab_size=127)).init_params(torch.Generator().manual_seed(2))
    text = model.text
    ids = torch.tensor([[0, 5, 63, 64, 100, 126]])
    want = text.token_embed[ids].detach()
    full = text.token_embed.detach().clone()
    parts = []
    for t in range(2):
        lo, hi = vocab_shard(127, t, 2)
        text.token_embed = torch.nn.Parameter(full[lo:hi].clone())
        text.tp, text.vocab_start = TPGroup(None, 2, t), lo  # no group: the sum is local
        emb = text.embed_tokens(ids)
        emb.sum().backward()
        inside = ((ids >= lo) & (ids < hi)).sum()
        assert text.token_embed.grad.sum().item() == pytest.approx(inside.item() * 32)
        parts.append(emb.detach())
    torch.testing.assert_close(parts[0] + parts[1], want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_orders_and_partial_mode(dtype):
    """``gemm_bias_residual``'s fp32 partial mode is the fp32 sum; the
    epilogue rounds in K1's order or the composed ``linear``'s."""
    g = torch.Generator().manual_seed(3)

    def ints(*shape):  # small integers: every sum exact, in any order
        return torch.randint(-4, 5, shape, generator=g).float()

    a, w, res = ints(6, 16).to(dtype), ints(16, 8).to(dtype), ints(6, 8).to(dtype)
    bias = ints(8) / 8
    acc = T.gemm_bias_residual(a, w, None)
    assert acc.dtype == torch.float32
    torch.testing.assert_close(acc, a.float() @ w.float(), rtol=0, atol=0)
    k1 = TP.tp_epilogue(acc, bias, res)
    torch.testing.assert_close(k1, T.gemm_bias_residual(a, w, bias, res), rtol=0, atol=0)
    composed = TP.tp_epilogue(acc, bias, res, composed=True)
    torch.testing.assert_close(composed, res + (acc.to(dtype) + bias.to(dtype)), rtol=0, atol=0)
    assert TP.LAUNCHES["tp_epilogue"] == 0


def test_tp_that_does_not_divide_heads_is_refused():
    from plip_tpu_torch.models.config import CLIPConfig, TextConfig, VisionConfig

    check_heads(ARCHITECTURES["ViT-B/32"](), 4)
    with pytest.raises(ValueError, match="vision tower's 12 heads"):
        check_heads(ARCHITECTURES["ViT-B/32"](), 8)
    with pytest.raises(ValueError, match="text tower's 12 heads"):
        check_heads(ARCHITECTURES["ViT-L/14"](), 8)
    odd = CLIPConfig(vision=VisionConfig(width=32, layers=1, heads=2, image_size=32,
                                         patch_size=16),
                     text=TextConfig(width=48, layers=1, heads=3, vocab_size=64,
                                     context_length=8), embed_dim=8)
    model = CLIP(odd)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="text tower's 3 heads"):
        shard_params(model, Mesh({"dp": 1, "tp": 2}))
    for k, v in model.state_dict().items():  # no weight moved
        assert torch.equal(v, before[k]), k
