"""The port's supervised fine-tuning (``train.finetune``, ``eval.fine_tuning``)
against the JAX package's (CPU).

- Each optimizer of ``_make_optimizer`` for three steps of a cosine-warmup
  schedule against optax's (allclose 1e-6): AdamW, Adagrad (optax's, not
  ``torch.optim.Adagrad``'s defaults), Adam (not the reference's Adagrad),
  SGD.
- ``FineTuner.tuner`` loss trajectories against the JAX tuner's with the same
  weights, images and labels: the ``plip`` backbone (a tiny CLIP ``.npz``,
  the JAX head copied in) and a tiny ViT registered in both packages, two
  steps (validation loss rtol 1e-4, F1 to 1e-6); a tiny ResNet's weights and
  BatchNorm running means after two steps against the JAX tuner's (cosine
  >= 0.999; the JAX package's running variance is the biased update, which
  the port does not copy, so its validation losses differ).
- ``tests/test_tuners.py``'s FineTuner cases on the port: end to end
  (``plip``, ``resnet18``), gradient accumulation equal to one pass, the
  BatchNorm and divisibility guards, BN buffers moving at ``lr=0`` while the
  affine parameters stay, the ``clip`` guard, an unknown model, Adam being
  Adam; the entry points on a missing card; preprocessing at the backbone's
  input size (the JAX package's is always 224); ``valid_evaluation`` without
  scikit-learn; ``FineTuningClassifier``.
"""

import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

pd = pytest.importorskip("pandas")

from plip_tpu.models import clip as jclip  # noqa: E402
from plip_tpu.models import resnet as jres  # noqa: E402
from plip_tpu.models import vit as jvit  # noqa: E402
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig  # noqa: E402
from plip_tpu.train import finetune as jft  # noqa: E402
from plip_tpu.train.scheduler import cosine_lr as jcosine_lr  # noqa: E402
from plip_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from plip_tpu_torch.eval.fine_tuning import FineTuningClassifier  # noqa: E402
from plip_tpu_torch.models import resnet as tres  # noqa: E402
from plip_tpu_torch.models import vit as tvit  # noqa: E402
from plip_tpu_torch.models.config import VisionConfig as TVisionConfig  # noqa: E402
from plip_tpu_torch.train import finetune as tft  # noqa: E402
from plip_tpu_torch.train.scheduler import cosine_lr  # noqa: E402

TINY_VIT = dict(width=32, layers=2, heads=2, image_size=224, patch_size=32)
TINY_RESNET = {"block": "basic", "layers": [1, 1, 1, 1]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores (a full-size ResNet-18 tuner run
    took 70 s there, 1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def tiny_archs():
    jvit.ARCHS["vit_port_tiny"] = VisionConfig(**TINY_VIT)
    tvit.ARCHS["vit_port_tiny"] = TVisionConfig(**TINY_VIT)
    jres.ARCHS["resnet_port_tiny"] = tres.ARCHS["resnet_port_tiny"] = TINY_RESNET
    yield
    for archs, k in ((jvit.ARCHS, "vit_port_tiny"), (tvit.ARCHS, "vit_port_tiny"),
                     (jres.ARCHS, "resnet_port_tiny"), (tres.ARCHS, "resnet_port_tiny")):
        archs.pop(k, None)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = CLIPConfig(
        vision=VisionConfig(width=32, layers=2, heads=2, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=2, heads=2, vocab_size=49408, context_length=77),
        embed_dim=16,
    )
    path = str(tmp_path_factory.mktemp("t") / "tiny.npz")
    params = jax.jit(jclip.init_params, static_argnums=1)(jax.random.PRNGKey(3), cfg)
    save_checkpoint(path, params, cfg)
    return path


def _label_df(d, size):
    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        arr[..., i % 2] //= 2  # the two classes differ a little
        p = str(d / f"im_{i}.png")
        Image.fromarray(arr).save(p)
        rows.append({"image": p, "label": i % 2})
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def image_label_df(tmp_path_factory):
    return _label_df(tmp_path_factory.mktemp("traindata"), (240, 260))


@pytest.fixture(scope="module")
def square_df(tmp_path_factory):
    """224x224 tiles: both packages' preprocessing is exact on them (no
    resample), so a BatchNorm tower sees bit-equal pixels in both."""
    return _label_df(tmp_path_factory.mktemp("square"), (224, 224))


def _args(model_name, optimizer="AdamW"):
    return SimpleNamespace(model_name=model_name, optimizer=optimizer, PC_CLIP_ARCH="ViT-B/32")


def _tune(ft, df, **kw):
    kw = {"batch_size": 4, "epochs": 2, "evaluation_steps": 0, "num_workers": 2, **kw}
    return ft.tuner(df, df.iloc[:4], **kw)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["AdamW", "Adagrad", "Adam", "SGD"])
def test_optimizers_match_optax(name):
    rng = np.random.default_rng(0)
    shapes = {"w": (5, 3), "b": (3,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jopt = jft._make_optimizer(name, jcosine_lr(1e-2, 1, 3), 0.1)
    state, want = jopt.init(p0), p0
    for g in grads:
        upd, state = jopt.update(g, state, want)
        want = optax.apply_updates(want, upd)
    topt = tft._make_optimizer(name, cosine_lr(1e-2, 1, 3), 0.1)
    got = {k: torch.tensor(v) for k, v in p0.items()}
    tstate = topt.init(got)
    for g in grads:
        topt.update_(got, {k: torch.tensor(v) for k, v in g.items()}, tstate)
    for k in p0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        assert not np.allclose(got[k].numpy(), p0[k], atol=1e-4)  # it did step
    if name == "Adagrad":  # not torch's Adagrad: accumulator 0, eps outside the root
        t = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
        torch_opt = torch.optim.Adagrad(t.values(), lr=1e-2)
        for g in grads:
            for k in t:
                t[k].grad = torch.tensor(g[k])
            torch_opt.step()
        assert not np.allclose(t["w"].detach().numpy(), got["w"].numpy(), atol=1e-6)


def test_adam_is_adam():
    """The reference's 'Adam' -> Adagrad copy-paste bug is not copied."""
    assert isinstance(tft._make_optimizer("Adam", 1e-3, 0.1), tft.FusedAdamW)
    assert tft._make_optimizer("Adam", 1e-3, 0.1).weight_decay == 0.0
    assert isinstance(tft._make_optimizer("Adagrad", 1e-3, 0.1), tft.Adagrad)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tft._make_optimizer("Lion", 1e-3, 0.1)


# ---------------------------------------------------------------------------
# Trajectories against the JAX tuner
# ---------------------------------------------------------------------------


def _pair(model_name, tiny_ckpt, optimizer="AdamW", **kw):
    backbone = tiny_ckpt if model_name == "plip" else None
    kw = {"num_classes": 2, "lr": 1e-3, "seed": 0, **kw}
    jt = jft.FineTuner(args=_args(model_name, optimizer), backbone=backbone, **kw)
    tt = tft.FineTuner(args=_args(model_name, optimizer), backbone=backbone, device="cpu",
                       **kw)
    if model_name == "plip":  # the same head
        with torch.no_grad():
            tt.model.head.kernel.copy_(torch.tensor(np.asarray(jt.params["head"]["kernel"])))
    elif model_name.startswith("vit"):
        tt.model.load_jax_params(jax.device_get(jt.params))
    else:
        tt.model.load_state_dict(tres.from_jax_params(jax.device_get(jt.params),
                                                      model_name).state_dict())
    return jt, tt


@pytest.mark.parametrize("model_name", ["plip", "vit_port_tiny"])
def test_loss_trajectory_matches_jax(tiny_ckpt, image_label_df, model_name):
    df = image_label_df.iloc[:4]  # two epochs of one step
    jt, tt = _pair(model_name, tiny_ckpt)
    want, got = _tune(jt, df), _tune(tt, df)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got["loss"].astype(float), want["loss"].astype(float),
                               rtol=1e-4)
    for col in ("f1_weighted", "f1_macro"):
        np.testing.assert_allclose(got[col], want[col], atol=1e-6)
    assert got["loss"].iloc[0] != got["loss"].iloc[1]  # the weights moved


def test_resnet_weights_after_training_match_jax(tiny_ckpt, square_df, monkeypatch):
    """A tiny ResNet's parameters and running means after two steps: each
    tensor's move from the start against the JAX tuner's, cosine >= 0.999.
    Not elementwise: the two packages' fp32 grads match to 1e-8 except where
    one element's ReLU or max-pool decision falls the other way (a value
    within rounding of a tie), which moves one channel by about 1% of its
    grad; a float64 run of the port puts such flips on either package. The
    run is SGD (linear in the grads; Adam's first steps are about lr *
    sign(g)) on 224x224 tiles (both packages' preprocessing is exact there).
    The running variances differ: the port's unbiased update against the
    JAX package's biased one."""
    # the JAX tuner's init jitted: the same numbers, one compile instead of one an op
    monkeypatch.setattr(jres, "init_params", jax.jit(jres.init_params,
                                                     static_argnames=("arch", "num_classes")))
    jt, tt = _pair("resnet_port_tiny", tiny_ckpt, "SGD", lr=0.1)
    start = {k: v.clone() for k, v in tt.model.state_dict().items()}
    _tune(jt, square_df, epochs=1)  # two steps
    _tune(tt, square_df, epochs=1)
    want = tres.from_jax_params(jax.device_get(jt.state.params),
                                "resnet_port_tiny").state_dict()
    for k, v in tt.model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert v.item() == 2
            continue
        moved, moved_jax = v - start[k], want[k] - start[k]
        assert moved_jax.abs().max() > 1e-4, k  # every tensor moved
        if k.endswith("running_var"):  # the unbiased update against the biased one
            assert (moved - moved_jax).abs().max() > 1e-6, k
        else:
            cos = torch.nn.functional.cosine_similarity(moved.flatten(), moved_jax.flatten(),
                                                        dim=0).item()
            assert cos >= 0.999, (k, cos)


# ---------------------------------------------------------------------------
# tests/test_tuners.py's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_name", ["plip", "resnet18"])
def test_finetuner_end_to_end(tiny_ckpt, image_label_df, model_name):
    ft = tft.FineTuner(args=_args(model_name), num_classes=2, lr=1e-4, device="cpu",
                       backbone=tiny_ckpt if model_name == "plip" else None)
    perf = ft.tuner(image_label_df, image_label_df.iloc[:4],
                    test_dataframe=image_label_df.iloc[4:], batch_size=4, epochs=2,
                    evaluation_steps=0, num_workers=2)
    assert list(perf.columns)[:4] == ["epoch", "loss", "f1_weighted", "f1_macro"]
    assert len(perf) == 2
    assert "f1_test_weighted" in perf.columns and "f1_test_macro" in perf.columns
    assert perf["f1_weighted"].dtype == float
    assert np.isfinite(perf["loss"].astype(float)).all()


def test_accum_matches_single(tiny_ckpt, image_label_df):
    """Accumulated cross-entropy is exact (summed, then divided once): the
    same deterministic run with accum_steps=2 and 1 gives the same losses
    (the JAX test's bars)."""
    losses = {}
    for k in (1, 2):
        ft = tft.FineTuner(args=_args("plip"), backbone=tiny_ckpt, num_classes=2, lr=1e-3,
                           seed=0, device="cpu")
        losses[k] = _tune(ft, image_label_df, accum_steps=k)["loss"].astype(float).to_numpy()
    np.testing.assert_allclose(losses[2], losses[1], rtol=2e-5, atol=1e-6)


def test_accum_guards(tiny_ckpt, image_label_df):
    ft = tft.FineTuner(args=_args("resnet18"), num_classes=2, lr=1e-4, device="cpu")
    with pytest.raises(ValueError, match="BatchNorm"):
        _tune(ft, image_label_df, epochs=1, accum_steps=2)
    ft2 = tft.FineTuner(args=_args("plip"), backbone=tiny_ckpt, num_classes=2, lr=1e-4,
                        device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        _tune(ft2, image_label_df, epochs=1, accum_steps=3)


def test_resnet_bn_buffer_semantics(image_label_df):
    """At lr=0 the running statistics still move (the train-mode forward
    updates them) while the affine parameters and convolutions stay (no
    step, no decay on buffers)."""
    ft = tft.FineTuner(args=_args("resnet_port_tiny"), num_classes=2, lr=0.0, device="cpu")
    before = {k: v.clone() for k, v in ft.model.state_dict().items()}
    _tune(ft, image_label_df, epochs=1)
    after = ft.model.state_dict()
    assert not torch.allclose(after["bn1.running_mean"], before["bn1.running_mean"])
    assert not torch.allclose(after["layer2.0.bn2.running_var"],
                              before["layer2.0.bn2.running_var"])
    for k in before:
        if not k.split(".")[-1].startswith(("running", "num_batches")):
            assert torch.equal(after[k], before[k]), k
    buffers = {n for n, _ in ft.model.named_buffers()}
    assert not buffers & {n for n, _ in ft.model.named_parameters()}
    assert not buffers & set(ft.opt_state.mu)  # the optimizer holds no buffer


def test_backbone_guards(tiny_ckpt):
    with pytest.raises(Exception, match="wrong"):
        tft.FineTuner(args=_args("clip"), backbone=tiny_ckpt, num_classes=2, device="cpu")
    with pytest.raises(Exception, match="No such model"):
        tft.FineTuner(args=_args("alexnet"), num_classes=2, device="cpu")


def test_entry_points_need_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tft.FineTuner(args=_args("resnet_port_tiny"), num_classes=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FineTuningClassifier(model_name="resnet_port_tiny").train_and_test(
            ["a"], [0], ["b"], [0])


def test_resnet_backbone_loads_a_torchvision_state_dict(tmp_path):
    """A torchvision-named ResNet file (``weights_only=True``): every weight
    but the head comes from the file; a pickled module is refused."""
    src = tres.ResNet("resnet_port_tiny", 7).init_params(torch.Generator().manual_seed(3))
    path = str(tmp_path / "r.pt")
    torch.save(src.state_dict(), path)
    ft = tft.FineTuner(args=_args("resnet_port_tiny"), backbone=path, num_classes=2,
                       device="cpu")
    for k, v in ft.model.state_dict().items():
        if k.startswith("fc."):
            assert v.shape[0] == 2
        else:
            assert torch.equal(v, src.state_dict()[k]), k
    pickled = str(tmp_path / "m.pt")
    torch.save(src, pickled)
    with pytest.raises(Exception, match="weights_only|Unsupported global"):
        tft.FineTuner(args=_args("resnet_port_tiny"), backbone=pickled, num_classes=2,
                      device="cpu")


def test_preprocessing_at_the_backbone_size(tmp_path, image_label_df):
    """A CLIP backbone at 64 px (the JAX tuner preprocesses at 224 always and
    cannot run it) trains and validates at 64."""
    cfg = CLIPConfig(
        vision=VisionConfig(width=32, layers=1, heads=2, image_size=64, patch_size=32),
        text=TextConfig(width=32, layers=1, heads=2, vocab_size=512, context_length=16),
        embed_dim=8)
    path = str(tmp_path / "px64.npz")
    save_checkpoint(path, jclip.init_params(jax.random.PRNGKey(0), cfg), cfg)
    ft = tft.FineTuner(args=_args("plip"), backbone=path, num_classes=2, device="cpu")
    assert ft.image_size == 64
    perf = _tune(ft, image_label_df, epochs=1)
    assert np.isfinite(perf["loss"].astype(float)).all()
    jt = jft.FineTuner(args=_args("plip"), backbone=path, num_classes=2)
    with pytest.raises(Exception):
        _tune(jt, image_label_df, epochs=1)


def test_valid_evaluation_matches_jax_metrics(tiny_ckpt, image_label_df):
    """``valid_evaluation``: the summed per-batch mean cross-entropy and the
    numpy F1s against the JAX tuner's (scikit-learn's) on the same weights."""
    from plip_tpu.data.datasets import ImageLabelDataset as JDataset
    from plip_tpu.data.loader import PrefetchLoader as JLoader
    from plip_tpu_torch.data.datasets import ImageLabelDataset
    from plip_tpu_torch.data.loader import PrefetchLoader

    jt, tt = _pair("plip", tiny_ckpt, num_classes=3)
    df = image_label_df.assign(label=[i % 3 for i in range(len(image_label_df))])
    jt.state = jft._TrainState(jt.params, None, jnp.zeros((), jnp.int32))
    jt._eval_fn = jax.jit(lambda p, x: jt._forward(p, x, False)[0])
    want = jt.valid_evaluation(JLoader(JDataset(df), 3, device_put=False), 3)
    got = tt.valid_evaluation(PrefetchLoader(ImageLabelDataset(df), 3, device="cpu"), 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], atol=1e-12)


def test_fine_tuning_classifier(tiny_ckpt, image_label_df):
    paths = list(image_label_df["image"])
    labels = ["tumor" if i % 2 else "stroma" for i in range(len(paths))]
    ft, (test_m, train_m) = FineTuningClassifier(
        model_name="plip", backbone=tiny_ckpt, epochs=1, batch_size=4,
        device="cpu").train_and_test(paths[:6], labels[:6], paths[6:], labels[6:])
    from plip_tpu.eval.metrics import eval_metrics

    keys = list(eval_metrics([0, 1], [0, 1])) + ["split"]
    assert list(test_m) == keys and list(train_m) == keys
    assert test_m["split"] == "test" and train_m["instances"] == 6
    assert ft.num_classes == 2 and ft.device == torch.device("cpu")


def test_training_logs_each_step(tiny_ckpt, image_label_df):
    records = []

    class Cap(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("port_finetune_test")
    log.addHandler(Cap())
    log.setLevel(logging.INFO)
    ft = tft.FineTuner(args=_args("plip"), logging=log, backbone=tiny_ckpt, num_classes=2,
                       device="cpu", warmup=1, lr=1e-4)
    _tune(ft, image_label_df, epochs=1, evaluation_steps=1)
    steps = [m for m in records if m.startswith("[Train - this batch]")]
    assert len(steps) == 2 and "new learning rate: 1.000e-04" in steps[0]
    assert sum(m.startswith("[Validation - this batch]") for m in records) == 2
