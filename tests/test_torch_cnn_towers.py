"""The port's CNN towers (``models.resnet``, ``models.densenet``) against the
JAX package's and against compact torch references (CPU).

- Tiny architectures registered in both packages' ``ARCHS`` (a basic and a
  bottleneck ResNet, a two-block DenseNet), 48 px: one JAX parameter tree
  with perturbed BatchNorm statistics into both (``from_jax_params``), the
  features and logits in eval and train mode (fp32, allclose 1e-4), and the
  train-mode grads of every weight (allclose 1e-4).
- torchvision-named state_dicts built locally (``tests/test_cnn_towers.py``'s
  compact torch ResNet-18 and DenseNet) load with a strict
  ``from_torch_state_dict`` (``features.``/``module.`` prefixes and the
  classifier handled) and give the reference's features; the port's
  state_dict converts back to the JAX package's tree unchanged.
- BatchNorm's running statistics in train mode: the port's equal
  ``torch.nn.BatchNorm2d``'s (the reference's torchvision towers); its
  running mean equals the JAX package's, its running variance is the
  unbiased update where the JAX package takes the biased one
  (``plip_tpu/models/resnet.py:53-58``, a fault the port does not copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import densenet as jdense
from plip_tpu.models import resnet as jres
from plip_tpu_torch.models import densenet as tdense
from plip_tpu_torch.models import resnet as tres
from tests.test_cnn_towers import TorchDenseNetTiny, TorchResNet18

TINY_RESNETS = {"port_res_basic": {"block": "basic", "layers": [1, 1, 1, 1]},
                "port_res_bottleneck": {"block": "bottleneck", "layers": [1, 2, 1, 1]}}
TINY_DENSENETS = {"port_dense_tiny": {"growth": 8, "blocks": [2, 2], "init_feats": 16}}
PX = 48
# the JAX towers jitted: one XLA compile a graph is much quicker on the CPU
# than the eager path's compile of every op
J_RES_FWD = jax.jit(jres.forward, static_argnums=(2, 3))
J_RES_FEATS = jax.jit(jres.forward_features, static_argnums=(2, 3))
J_DENSE_FEATS = jax.jit(jdense.forward_features, static_argnums=(2, 3))


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
    for archs, tiny in ((jres.ARCHS, TINY_RESNETS), (tres.ARCHS, TINY_RESNETS),
                        (jdense.ARCHS, TINY_DENSENETS), (tdense.ARCHS, TINY_DENSENETS)):
        archs.update(tiny)
    yield
    for archs, tiny in ((jres.ARCHS, TINY_RESNETS), (tres.ARCHS, TINY_RESNETS),
                        (jdense.ARCHS, TINY_DENSENETS), (tdense.ARCHS, TINY_DENSENETS)):
        for k in tiny:
            archs.pop(k, None)


def _perturb_bn(tree, rng):
    """Every BN leaf set ``{scale, bias, mean, var}`` drawn away from the
    identity, so eval-mode BN is exercised."""
    if isinstance(tree, list):
        return [_perturb_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return np.asarray(tree)
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = np.asarray(tree["mean"]).shape
        return {"scale": rng.normal(1.0, 0.1, c).astype(np.float32),
                "bias": rng.normal(0.0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0.0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.6, 1.6, c).astype(np.float32)}
    return {k: _perturb_bn(v, rng) for k, v in tree.items()}


def _images(n=3, seed=0):
    return np.random.default_rng(seed).standard_normal((n, PX, PX, 3)).astype(np.float32)


def _resnet_pair(arch, num_classes=3):
    params = _perturb_bn(jax.device_get(jax.jit(jres.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), arch, num_classes)), np.random.default_rng(1))
    return params, tres.from_jax_params(params, arch)


def _densenet_pair(arch):
    params = _perturb_bn(jax.device_get(jax.jit(jdense.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), arch)), np.random.default_rng(3))
    return params, tdense.from_jax_params(params, arch)


def _bn_leaves(stats, prefix=""):
    """The JAX package's returned BN statistics -> {torch BN name: (mean, var)}."""
    out = {}
    if isinstance(stats, list):
        for i, s in enumerate(stats):
            out.update(_bn_leaves(s, f"{prefix}{i}."))
        return out
    if set(stats) == {"mean", "var"}:
        return {prefix[:-1]: (np.asarray(stats["mean"]), np.asarray(stats["var"]))}
    for k, s in stats.items():
        name = {"downsample": "downsample.1", "bn": ""}.get(k, k)
        out.update(_bn_leaves(s, f"{prefix}{name}." if name else prefix))
    return out


def _port_bn(model):
    return {n: (m.running_mean.numpy(), m.running_var.numpy(), m.num_batches_tracked.item())
            for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}


@pytest.mark.parametrize("arch", list(TINY_RESNETS))
@pytest.mark.parametrize("training", [False, True])
def test_resnet_matches_jax(arch, training):
    params, model = _resnet_pair(arch)
    model.train(training)
    x = _images()
    with torch.no_grad():
        feats = model.forward_features(torch.from_numpy(x)).numpy()
    model_eval_state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    want_f, _ = J_RES_FEATS(params, jnp.asarray(x), arch, training)
    want_l, _ = J_RES_FWD(params, jnp.asarray(x), arch, training)
    assert feats.shape == (3, tres.n_features(arch)) and logits.shape == (3, 3)
    np.testing.assert_allclose(feats, np.asarray(want_f), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, np.asarray(want_l), rtol=1e-4, atol=1e-4)
    if not training:  # eval mode moves no statistic
        for k, v in model.state_dict().items():
            assert torch.equal(v, model_eval_state[k]), k


@pytest.mark.parametrize("arch", list(TINY_DENSENETS))
@pytest.mark.parametrize("training", [False, True])
def test_densenet_matches_jax(arch, training):
    params, model = _densenet_pair(arch)
    model.train(training)
    x = _images(seed=1)
    with torch.no_grad():
        got = model.forward_features(torch.from_numpy(x)).numpy()
    want, _ = J_DENSE_FEATS(params, jnp.asarray(x), arch, training)
    assert got.shape == (3, tdense.n_features(arch))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tower", ["port_res_basic", "port_dense_tiny"])
def test_train_mode_grads_match_jax(tower):
    """Train-mode BN (batch statistics) under autograd: d(sum(out^2)) for every
    weight, the JAX package's ``jax.grad`` converted to torch layouts."""
    x = _images(seed=2)
    if tower in TINY_RESNETS:
        params, model = _resnet_pair(tower)
        jfn = lambda p: J_RES_FWD(p, jnp.asarray(x), tower, True)[0]  # noqa: E731
        to_torch = lambda p: tres.from_jax_params(p, tower)  # noqa: E731
    else:
        params, model = _densenet_pair(tower)
        jfn = lambda p: J_DENSE_FEATS(p, jnp.asarray(x), tower, True)[0]  # noqa: E731
        to_torch = lambda p: tdense.from_jax_params(p, tower)  # noqa: E731
    model.train()
    (model(torch.from_numpy(x)) ** 2).sum().backward()
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jfn(p) ** 2)))(params)
    # the grads as a tree of the same shape: BN mean/var get zero grads there
    want = to_torch(jax.device_get(jgrads)).state_dict()
    n = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
        n += 1
    assert n == len(list(model.parameters())) > 10


def test_running_statistics_follow_torch_batch_norm():
    """One train-mode forward of torchvision's ResNet-18 graph (compact torch
    reference, ``nn.BatchNorm2d``) and of the port from its state_dict: every
    BN's running mean and variance and its step count equal the reference's.
    The JAX package's running mean is the same; its running variance is the
    biased update, which the port does not copy."""
    torch.manual_seed(0)
    ref = TorchResNet18()
    model = tres.from_torch_state_dict(ref.state_dict(), "resnet18")
    # a copy: the JAX converter's arrays may alias the reference's buffers
    params = jres.from_torch_state_dict({k: v.clone() for k, v in ref.state_dict().items()},
                                        "resnet18")
    ref.train(), model.train()
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(model.forward_features(torch.from_numpy(x)).numpy(),
                                   ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy(),
                                   rtol=1e-4, atol=1e-4)
    want = _port_bn(ref)
    got = _port_bn(model)
    assert got.keys() == want.keys() and len(got) == 20
    for k in want:
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=1e-5, atol=1e-7, err_msg=k)
        assert got[k][2] == want[k][2] == 1
    _, stats = J_RES_FEATS(params, jnp.asarray(x), "resnet18", True)
    jax_bn = _bn_leaves(stats)
    assert jax_bn.keys() == got.keys()
    rows = _bn_rows(model, x)
    for k, (mean, var) in jax_bn.items():
        # the same statistic to fp32 rounding (the layers' sums differ in order)
        np.testing.assert_allclose(got[k][0], mean, rtol=1e-5, atol=1e-6, err_msg=k)
        # var = 0.9 * 1 + 0.1 * v: the port's v is the JAX one times n / (n - 1)
        n = rows[k]
        biased = (var - 0.9) / 0.1
        np.testing.assert_allclose(got[k][1], 0.9 + 0.1 * biased * n / (n - 1), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert np.abs(got[k][1] - var).max() > 1e-6, k


def _bn_rows(model, x):
    """{BN name: B * H * W at its input}, by forward hooks on an eval run."""
    rows, hooks = {}, []

    def count(name):
        def hook(module, inputs, output):
            rows[name] = inputs[0].numel() // inputs[0].shape[1]
        return hook

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(count(name)))
    with torch.no_grad():
        model.eval()
        model.forward_features(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return rows


def test_torchvision_resnet_state_dict():
    torch.manual_seed(0)
    ref = TorchResNet18().eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.6, 1.6)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
    sd = ref.state_dict()
    model = tres.from_torch_state_dict(sd, "resnet18").eval()
    assert model.fc is None
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        np.testing.assert_allclose(model.forward_features(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
    # the fc head with include_fc, dropped without it
    fc = {"fc.weight": torch.randn(5, 512), "fc.bias": torch.randn(5)}
    with_fc = tres.from_torch_state_dict({**sd, **fc}, "resnet18", include_fc=True).eval()
    assert with_fc.fc.out_features == 5
    with torch.no_grad():
        np.testing.assert_allclose(with_fc(torch.from_numpy(x)).numpy(),
                                   want @ fc["fc.weight"].numpy().T + fc["fc.bias"].numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert tres.from_torch_state_dict({**sd, **fc}, "resnet18").fc is None
    # strict: a missing or an unknown key raises
    with pytest.raises(RuntimeError, match="layer4.1.bn2.running_var"):
        tres.from_torch_state_dict({k: v for k, v in sd.items()
                                    if k != "layer4.1.bn2.running_var"}, "resnet18")
    with pytest.raises(RuntimeError, match="Unexpected"):
        tres.from_torch_state_dict({**sd, "layer9.weight": torch.zeros(1)}, "resnet18")
    # the port's state_dict converts back to the JAX package's tree unchanged
    back = jres.from_torch_state_dict(model.state_dict(), "resnet18")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jres.from_torch_state_dict(
            sd, "resnet18"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torchvision_densenet_state_dict():
    torch.manual_seed(1)
    ref = TorchDenseNetTiny().eval()
    sd = ref.state_dict()
    # torchvision's naming (features., classifier) and mtdp's (module.)
    tv = {f"features.{k}": v for k, v in sd.items()}
    tv.update({"classifier.weight": torch.zeros(3, 32), "classifier.bias": torch.zeros(3)})
    mtdp = {f"module.{k}": v for k, v in sd.items()}
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    for d in (sd, tv, mtdp):
        model = tdense.from_torch_state_dict(d, "port_dense_tiny").eval()
        with torch.no_grad():
            np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(), want, rtol=1e-4,
                                       atol=1e-4)
    back = jdense.from_torch_state_dict(model.state_dict(), "port_dense_tiny")
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jdense.from_torch_state_dict(sd, "port_dense_tiny"))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_feature_dims_and_architectures():
    assert tres.ARCHS.keys() >= {"resnet18", "resnet34", "resnet50", "resnet101"}
    assert tdense.ARCHS.keys() >= {"densenet121", "densenet169", "densenet201"}
    for arch in tres.ARCHS:
        assert tres.n_features(arch) == jres.n_features(arch)
    for arch in tdense.ARCHS:
        assert tdense.n_features(arch) == jdense.n_features(arch)
    assert tdense.n_features("densenet121") == 1024
    # the full-size towers hold the JAX package's parameter counts
    for arch in ("resnet50", "densenet121"):
        mod, jm = (tres, jres) if arch.startswith("res") else (tdense, jdense)
        model = mod.ResNet(arch) if mod is tres else mod.DenseNet(arch)
        jp = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), arch))
        assert sum(p.numel() for p in model.parameters()) + sum(
            b.numel() for n, b in model.named_buffers() if not n.endswith("tracked")) == sum(
            int(np.prod(a.shape)) for a in jax.tree.leaves(jp))


def test_init_draws_from_the_generator():
    a = tres.ResNet("port_res_basic", 4).init_params(torch.Generator().manual_seed(7))
    b = tres.ResNet("port_res_basic", 4).init_params(torch.Generator().manual_seed(7))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.conv1.weight
    assert abs(w.std().item() - (2.0 / w[0].numel()) ** 0.5) < 0.01
    bn = a.layer1[0].bn1
    assert torch.equal(bn.weight, torch.ones_like(bn.weight)) and not bn.running_mean.any()
