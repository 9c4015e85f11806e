"""The port's training path against the JAX package's (CPU).

One JAX parameter tree goes into both packages (``from_jax_params``); the
same batches, made with numpy from a seed, go through both. The loss and
grads are held against ``jax.value_and_grad(clip_loss)`` with
``PLIP_TPU_INTERPRET=1``, so that K1 and K2 run there in Pallas interpret
mode (bars: loss rtol 2e-5, every leaf rtol 5e-5 and atol 5e-5, the bars
``test_interpret_e2e.py`` holds the JAX paths to); the remat policies and
gradient accumulation against the port's own single pass; the optimizer,
schedule, train steps, augmentation warp, host crops and train-state files
against the JAX package's; and the tuner end to end."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu.train import contrastive as jc
from plip_tpu_torch.models import clip as tclip
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(m, context_length=16):
    """The config of test_interpret_e2e.py (vision S=5, text S=16)."""
    return m.CLIPConfig(
        vision=m.VisionConfig(width=32, layers=2, heads=2, image_size=32, patch_size=16),
        text=m.TextConfig(width=32, layers=2, heads=2, vocab_size=128,
                          context_length=context_length),
        embed_dim=16)


def _batch(cfg, B=8, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.standard_normal((B, cfg.vision.image_size, cfg.vision.image_size, 3))
    ids = np.zeros((B, cfg.text.context_length), np.int32)
    ids[:, 0] = 1
    ids[:, 1:4] = rng.integers(2, 120, (B, 3))
    ids[:, 4] = cfg.text.eot
    return px.astype(np.float32), ids


def _pair(context_length=16, seed=0, logit_scale=None):
    jcfg, tcfg = _tiny(jconfig, context_length), _tiny(tconfig, context_length)
    params = jax.device_get(jclip.init_params(jax.random.PRNGKey(seed), jcfg))
    if logit_scale is not None:
        params = {**params, "logit_scale": np.float32(logit_scale)}
    model = tclip.CLIP(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    return params, jcfg, model, tcfg


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _port_loss_grads(model, px, ids, remat=False):
    model.zero_grad(set_to_none=True)
    loss, _ = tc.clip_loss(model, torch.from_numpy(px), torch.from_numpy(ids).long(),
                           torch.float32, remat)
    loss.backward()
    return loss.item(), _grads(model)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, rtol, atol):
    got, want = _jax_leaves(got), _jax_leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# Loss and grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("context_length", [16, 13])
def test_loss_and_grads_match_jax_kernels(monkeypatch, context_length):
    """fp32 ``clip_loss`` and every grad leaf against the JAX package with K1
    and K2 live (interpret mode). At context 13 JAX pads the text to 16 and
    the port runs it unpadded."""
    params, jcfg, model, tcfg = _pair(context_length)
    px, ids = _batch(tcfg)
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")

    def f(p):
        return jc.clip_loss(p, jnp.asarray(px), jnp.asarray(ids), jcfg, jnp.float32)[0]

    loss_j, grads_j = jax.value_and_grad(f)(params)
    loss_t, grads_t = _port_loss_grads(model, px, ids)
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=2e-5)
    _assert_trees_close(to_jax_params(grads_t, tcfg), jax.device_get(grads_j),
                        rtol=5e-5, atol=5e-5)


def test_every_attention_parameter_gets_its_grad():
    """The repair: loss.backward() through CLIP reaches every attention
    parameter of every layer of both towers, and in fp32 each grad equals
    torch.autograd's through the plain forward."""
    _, _, model, tcfg = _pair()
    px, ids = _batch(tcfg)
    _, got = _port_loss_grads(model, px, ids)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlayers, "attention_sublayer", T.attention_sublayer_reference)
        _, want = _port_loss_grads(model, px, ids)
    attn = [k for k in got if ".blocks." in k and (".attn." in k or ".ln1." in k)]
    assert len(attn) == 2 * 2 * 6
    for k in attn:
        assert got[k].abs().max() > 0, k
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6, msg=k)


@pytest.mark.parametrize("remat", ["mlp", True, ("mlp", True)])
def test_remat_policies_give_equal_grads(remat):
    _, _, model, tcfg = _pair()
    px, ids = _batch(tcfg)
    loss0, want = _port_loss_grads(model, px, ids, remat=False)
    loss1, got = _port_loss_grads(model, px, ids, remat=remat)
    assert loss1 == loss0
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-9, msg=k)


def test_unported_remat_policy_raises():
    """Every policy of the JAX package is ported ("block" and "mlp_h1"
    included); a name that is none of them raises and lists them."""
    _, _, model, tcfg = _pair()
    px, ids = _batch(tcfg)
    with pytest.raises(ValueError, match="mlp_h1"):
        tc.clip_loss(model, torch.from_numpy(px), torch.from_numpy(ids).long(),
                     torch.float32, "blocks")


@pytest.mark.parametrize("k", [2, 4])
def test_accum_grads_match_single_pass(k):
    """The two-pass accumulation gives the single-pass loss and grads (the
    bars of test_grad_accum.py)."""
    _, _, model, tcfg = _pair(seed=1)
    px, ids = _batch(tcfg, B=16, seed=7)
    loss_ref, want = _port_loss_grads(model, px, ids)
    model.zero_grad(set_to_none=True)
    loss, metrics = tc._accum_infonce_grads(model, torch.from_numpy(px),
                                            torch.from_numpy(ids).long(),
                                            torch.float32, False, k)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]), loss_ref, rtol=1e-6)
    got = _grads(model)
    assert abs(float(want["logit_scale"])) > 0
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=2e-5, atol=2e-6, msg=name)


def test_accum_requires_divisible_batch():
    _, _, model, tcfg = _pair()
    px, ids = _batch(tcfg)
    with pytest.raises(ValueError, match="divisible"):
        tc._accum_infonce_grads(model, torch.from_numpy(px), torch.from_numpy(ids).long(),
                                torch.float32, False, 3)


# ---------------------------------------------------------------------------
# Optimizer, schedule and train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(5e-6, 50, 1000), (1e-3, 2, 10), (1e-4, 3, 3)])
def test_cosine_lr_matches_jax(args):
    from plip_tpu.train.scheduler import cosine_lr as jax_lr
    from plip_tpu_torch.train.scheduler import cosine_lr

    want = [float(jax_lr(*args)(s)) for s in range(args[2] + 3)]
    got = [cosine_lr(*args)(s) for s in range(args[2] + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_fused_adamw_matches_jax():
    """Three updates of random params with random grads: same stepping (lr
    at the pre-increment count, bias correction at count + 1, decay)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 7), "b": (3,), "c": ()}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jopt = jc.make_optimizer(1e-2, warmup=2, total_steps=5, weight_decay=0.1)
    topt = tc.make_optimizer(1e-2, warmup=2, total_steps=5, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = topt.init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        topt.update_(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
            np.testing.assert_allclose(tstate.mu[k].numpy(), np.asarray(jstate.mu[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=k)
    assert tstate.count == int(jstate.count) == 3


def _split_key_bias(tree, width):
    """Take the key columns of the qkv biases out of a params tree. Their
    grad is zero in exact arithmetic (a shift of every key moves each row's
    logits by one constant, which the softmax ignores), so what the two
    packages compute there is rounding noise, which AdamW turns into steps
    of about +-lr of either sign."""
    tree = jax.tree.map(np.array, tree)
    keys = []
    for tower in ("visual", "text"):
        b = tree[tower]["blocks"]["attn"]["qkv"]["bias"]
        keys.append(b[:, width[tower]:2 * width[tower]].copy())
        b[:, width[tower]:2 * width[tower]] = 0.0
    return tree, np.concatenate([k.ravel() for k in keys])


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_steps_match_jax(accum_steps):
    """Three steps of ``make_train_step`` in both packages from one state and
    batch; the logit scale starts above ln 100, so the forward's clamp and
    the update's clamp both cut it. The params agree after each step, but
    for the key biases, which only have to stay within the steps' size. A
    first AdamW step is lr * g / (|g| + eps), so a grad within rounding of
    eps moves by a share of lr: the bar is lr / 10."""
    lr, steps = 1e-4, 3
    params, jcfg, model, tcfg = _pair(seed=1, logit_scale=4.7)
    width = {"visual": tcfg.vision.width, "text": tcfg.text.width}
    px, ids = _batch(tcfg, B=8, seed=3)
    jopt = jc.make_optimizer(lr, warmup=2, total_steps=10)
    jstep = jc.make_train_step(jcfg, jopt, dtype=jnp.float32, accum_steps=accum_steps)
    jstate = jc.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    topt = tc.make_optimizer(lr, warmup=2, total_steps=10)
    tstep = tc.make_train_step(tcfg, topt, dtype=torch.float32, accum_steps=accum_steps)
    tstate = tc.init_train_state(model, topt)
    pxt, idst = torch.from_numpy(px), torch.from_numpy(ids).long()
    for _ in range(steps):
        jstate, jm = jstep(jstate, jnp.asarray(px), jnp.asarray(ids))
        tstate, tm = tstep(tstate, pxt, idst)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)
        got, got_k = _split_key_bias(to_jax_params(tstate.model, tcfg), width)
        want, want_k = _split_key_bias(jax.device_get(jstate.params), width)
        _assert_trees_close(got, want, rtol=1e-5, atol=lr / 10)
        assert np.abs(got_k - want_k).max() <= 2 * steps * lr
    assert tstate.model.logit_scale.item() == pytest.approx(tcfg.logit_scale_max, rel=1e-3)
    assert tstate.step == steps


# ---------------------------------------------------------------------------
# Train state files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_state_after_one_step(tmp_path_factory):
    """The JAX package's train state after one step, and its file (read
    only by the tests)."""
    params, jcfg, _, tcfg = _pair(seed=2)
    px, ids = _batch(tcfg, seed=4)
    jopt = jc.make_optimizer(1e-3, warmup=2, total_steps=10)
    jstep = jc.make_train_step(jcfg, jopt, dtype=jnp.float32)
    jstate = jc.init_train_state(jax.tree.map(jnp.asarray, params), jopt)
    jstate, _ = jstep(jstate, jnp.asarray(px), jnp.asarray(ids))
    path = str(tmp_path_factory.mktemp("jax_state") / "state.npz")
    jc.save_train_state(path, jstate, jcfg)
    return path, jopt, jstep, jstate, px, ids


def test_jax_train_state_resumes_in_port(jax_state_after_one_step):
    """A state written by the JAX package loads into the port with its
    moments, count and step, and the next step of both agrees."""
    path, jopt, jstep, jstate, px, ids = jax_state_after_one_step
    topt = tc.make_optimizer(1e-3, warmup=2, total_steps=10)
    tstate, tcfg = tc.load_train_state(path, topt)
    assert tstate.step == 1 and tstate.opt_state.count == 1
    _assert_trees_close(to_jax_params(tstate.opt_state.mu, tcfg),
                        jax.device_get(jstate.opt_state.mu), rtol=0, atol=0)
    _assert_trees_close(to_jax_params(tstate.opt_state.nu, tcfg),
                        jax.device_get(jstate.opt_state.nu), rtol=0, atol=0)
    tstep = tc.make_train_step(tcfg, topt, dtype=torch.float32)
    tstate, tm = tstep(tstate, torch.from_numpy(px), torch.from_numpy(ids).long())
    jstate, jm = jstep(jstate, jnp.asarray(px), jnp.asarray(ids))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=2e-5)
    width = {"visual": tcfg.vision.width, "text": tcfg.text.width}
    got, got_k = _split_key_bias(to_jax_params(tstate.model, tcfg), width)
    want, want_k = _split_key_bias(jax.device_get(jstate.params), width)
    _assert_trees_close(got, want, rtol=1e-5, atol=1e-4)  # lr 1e-3
    assert np.abs(got_k - want_k).max() <= 4e-3


def test_port_train_state_loads_in_jax(jax_state_after_one_step, tmp_path):
    """The port writes the JAX package's layout: its file loads through
    ``plip_tpu.train.contrastive.load_train_state`` leaf for leaf."""
    path, jopt, _, _, px, ids = jax_state_after_one_step
    topt = tc.make_optimizer(1e-3, warmup=2, total_steps=10)
    tstate, tcfg = tc.load_train_state(path, topt)
    tstep = tc.make_train_step(tcfg, topt, dtype=torch.float32)
    tstate, _ = tstep(tstate, torch.from_numpy(px), torch.from_numpy(ids).long())
    out = str(tmp_path / "port.npz")
    tc.save_train_state(out, tstate, tcfg)
    jstate, _ = jc.load_train_state(out, jopt)
    assert int(jstate.step) == 2 and int(jstate.opt_state.count) == 2
    _assert_trees_close(jax.device_get(jstate.params), to_jax_params(tstate.model, tcfg),
                        rtol=0, atol=0)
    _assert_trees_close(jax.device_get(jstate.opt_state.nu),
                        to_jax_params(tstate.opt_state.nu, tcfg), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Augmentation, host crops, loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_normalize_matches_jax(seed):
    """Same (M, offsets, flip), drawn by the JAX package: same pixels."""
    from plip_tpu.ops import augment as ja
    from plip_tpu_torch.ops import augment as ta

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
    base = 127 + 100 * np.sin(yy[..., None] / 7 + xx[..., None] / 11 + np.arange(3))
    images = np.clip(base[None] + rng.normal(0, 8, (4, 64, 64, 3)), 0, 255).astype(np.uint8)
    jcfg, tcfg = ja.AugmentConfig(out_size=48), ta.AugmentConfig(out_size=48)
    M, offsets, flip = ja.sample_warp(jax.random.PRNGKey(seed), 4, 64, jcfg)
    want = np.asarray(ja.warp_normalize(jnp.asarray(images), M, offsets, flip, jcfg))
    got = ta.warp_normalize(torch.from_numpy(images), torch.tensor(np.asarray(M)),
                            torch.tensor(np.asarray(offsets)),
                            torch.tensor(np.asarray(flip)), tcfg)
    assert got.shape == (4, 48, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_augment_draws_follow_the_generator():
    """The draws come from the generator given: the same seed gives the same
    batch; the maps stay within the configured ranges."""
    from plip_tpu_torch.ops import augment as ta

    cfg = ta.AugmentConfig(out_size=24)
    images = torch.randint(0, 256, (16, 32, 32, 3), dtype=torch.uint8)
    a = ta.augment_batch(torch.Generator().manual_seed(5), images, cfg)
    b = ta.augment_batch(torch.Generator().manual_seed(5), images, cfg)
    c = ta.augment_batch(torch.Generator().manual_seed(6), images, cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (16, 24, 24, 3) and torch.isfinite(a).all()
    M, offsets, flip = ta.sample_warp(torch.Generator().manual_seed(0), 512, 32, cfg)
    assert M.shape == (512, 3, 3) and offsets.min() >= 0 and offsets.max() <= 8
    assert 0.4 < flip.float().mean() < 0.6


@pytest.mark.parametrize("shape,epoch,index", [((240, 260, 3), 0, 0),
                                               ((600, 520, 3), 1, 5),
                                               ((512, 512, 3), 2, 3)])
def test_train_transform_matches_jax(shape, epoch, index):
    from plip_tpu.data.transform import TrainTransform as JaxTransform
    from plip_tpu_torch.data.transform import TrainTransform

    img = np.random.default_rng(index).integers(0, 256, shape, dtype=np.uint8)
    want = JaxTransform(first_resize=256, n_px=224, epoch=epoch)(img, index=index)
    got = TrainTransform(first_resize=256, n_px=224, epoch=epoch)(img, index=index)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_prefetch_loader_matches_jax():
    """Same batches, padding and counts as the JAX package's loader."""
    from plip_tpu.data.loader import PrefetchLoader as JaxLoader
    from plip_tpu_torch.data.loader import PrefetchLoader

    data = [(np.full((2, 3), i, np.uint8), f"caption {i}") for i in range(7)]
    want = list(JaxLoader(data, 3, num_workers=2, device_put=False))
    got = list(PrefetchLoader(data, 3, num_workers=2, device="cpu"))
    assert [n for _, n in got] == [n for _, n in want] == [3, 3, 1]
    for ((gi, gc), _), ((wi, wc), _) in zip(got, want):
        assert isinstance(gi, torch.Tensor) and gc == wc
        np.testing.assert_array_equal(gi.numpy(), wi)


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tuner_data(tmp_path_factory):
    """A tiny ViT-B/32-shaped backbone (224 px, 77 tokens) and 8 JPEGs."""
    from PIL import Image

    from plip_tpu.utils.checkpoint import save_checkpoint

    jcfg = jconfig.CLIPConfig(
        vision=jconfig.VisionConfig(width=32, layers=2, heads=2, image_size=224,
                                    patch_size=32),
        text=jconfig.TextConfig(width=32, layers=2, heads=2, vocab_size=49408,
                                context_length=77),
        embed_dim=16)
    d = tmp_path_factory.mktemp("tuner")
    backbone = str(d / "tiny.npz")
    save_checkpoint(backbone, jclip.init_params(jax.random.PRNGKey(3), jcfg), jcfg)
    rng = np.random.default_rng(0)
    images, captions = [], []
    for i in range(8):
        p = str(d / f"im_{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (240, 260, 3), dtype=np.uint8)).save(p)
        images.append(p)
        captions.append(f"an H&E image of class {i % 2}")
    train = {"image": images, "caption": captions}
    valid = {"image": images[:4], "caption": captions[:4]}
    return backbone, train, valid


def _records():
    records = []
    log = SimpleNamespace(info=lambda msg, *a: records.append(msg % a if a else msg),
                          warning=lambda msg, *a: records.append(msg % a if a else msg))
    return records, log


def _train_losses(records):
    return [float(r.rsplit("loss: ", 1)[1]) for r in records if "[Train - this batch]" in r]


def _tuner(backbone, **kw):
    from plip_tpu_torch.train.clip_tuner import CLIPTuner

    return CLIPTuner(args=SimpleNamespace(first_resize=256, pxsize=224, optimizer="AdamW"),
                     backbone=backbone, lr=1e-4, warmup=2, device="cpu", **kw)


def test_clip_tuner_end_to_end(tuner_data, tmp_path):
    """Two epochs on the CPU; the epoch checkpoint loads in plip_tpu and
    embeds there as the port embeds it."""
    from plip_tpu.utils.checkpoint import load_checkpoint

    backbone, train, valid = tuner_data
    tuner = _tuner(backbone)
    records, tuner.logging = _records()
    suffix = tuner.tuner(train, valid, save_directory=str(tmp_path), batch_size=4,
                         epochs=2, evaluation_steps=1, num_workers=2, start_time="ts")
    assert suffix == "_ts_model.npz"
    losses = _train_losses(records)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert sum("[Validation - final]" in r for r in records) == 2
    path = str(tmp_path / "epoch_1_ts_model.npz")
    assert os.path.exists(tmp_path / "epoch_0_ts_model.npz")
    params, jcfg = load_checkpoint(path)
    px = np.random.default_rng(1).standard_normal((2, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(params, jnp.asarray(px), jcfg))
    with torch.no_grad():
        got = tuner.model.encode_image(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    init, _ = load_checkpoint(backbone)
    assert not np.allclose(params["visual"]["proj"]["kernel"],
                           init["visual"]["proj"]["kernel"])


def test_clip_tuner_resumes_full_state(tuner_data, tmp_path):
    """``save_full_state`` writes the train state, and ``resume_from``
    restarts from it: params, moments and step."""
    backbone, train, valid = tuner_data
    first = _tuner(backbone)
    first.logging = _records()[1]
    first.tuner(train, valid, save_directory=str(tmp_path), batch_size=4, epochs=1,
                evaluation_steps=0, num_workers=2, start_time="a", save_full_state=True)
    path = str(tmp_path / "epoch_0_a_model.npz")
    assert os.path.exists(path + ".opt.npz")
    second = _tuner(backbone)
    second.logging = _records()[1]
    second.tuner(train, valid, save_directory=str(tmp_path), batch_size=4, epochs=1,
                 evaluation_steps=0, num_workers=2, start_time="b", resume_from=path)
    assert second.state.step == 4 and second.state.opt_state.count == 4


def test_clip_tuner_auto_accum_retries_after_oom(tuner_data, tmp_path, monkeypatch):
    """accum_steps="auto": a first step that runs out of device memory is
    run again from the initial weights at the smallest accumulation that
    divides the batch, and the run then equals an explicit accum_steps=2
    run."""
    import plip_tpu_torch.train.clip_tuner as ct

    backbone, train, valid = tuner_data
    real_make = ct.make_train_step
    built = []

    def fake_make(cfg, opt, dtype=None, remat=False, accum_steps=1, mesh=None):
        built.append(accum_steps)
        step = real_make(cfg, opt, dtype=dtype, remat=remat, accum_steps=accum_steps,
                         mesh=mesh)

        def wrapped(state, px, ids):
            if accum_steps < 2:
                step(state, px, ids)  # a step that got far, then failed
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
            return step(state, px, ids)

        return wrapped

    def run(accum, make):
        monkeypatch.setattr(ct, "make_train_step", make)
        tuner = _tuner(backbone, accum_steps=accum)
        records, tuner.logging = _records()
        tuner.tuner(train, valid, save_directory=str(tmp_path), batch_size=4, epochs=1,
                    evaluation_steps=0, num_workers=2, start_time=str(accum))
        return _train_losses(records), records, tuner

    losses_auto, records, tuner = run("auto", fake_make)
    assert built[:2] == [1, 2], built
    assert any("OOM at accum_steps=1" in r for r in records)
    losses_k2, _, tuner_k2 = run(2, real_make)
    np.testing.assert_allclose(losses_auto, losses_k2, rtol=2e-5)
    for (k, a), (_, b) in zip(tuner.model.state_dict().items(),
                              tuner_k2.model.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=k)


def test_next_divisor():
    from plip_tpu_torch.train.clip_tuner import _next_divisor

    assert _next_divisor(8, 1) == 2
    assert _next_divisor(8, 2) == 4
    assert _next_divisor(6, 2) == 3
    assert _next_divisor(7, 1) == 7
    assert _next_divisor(4, 4) is None


def test_tuner_on_a_missing_card_raises(tuner_data):
    """Asked for cuda where there is none, the tuner does not train on the
    CPU instead."""
    from plip_tpu_torch.train.clip_tuner import CLIPTuner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        CLIPTuner(backbone=tuner_data[0], device="cuda")
