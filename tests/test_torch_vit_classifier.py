"""The port's ViT classifier (``models.vit``) and the blocks' ``act`` switch
against the JAX package (CPU).

- A 2-layer ViT registered in both packages' ``ARCHS`` (width 64, 2 heads,
  16-px patches at 32 and 48 px: S=5 and S=10): one JAX tree into both
  (``ViTClassifier.load_jax_params``), the logits and every grad leaf
  against ``plip_tpu.models.vit.forward`` and its ``jax.grad`` with
  ``PLIP_TPU_INTERPRET=1``, so K1 and K2 run there in Pallas interpret mode
  (bars: row cosine > 0.9999 and allclose 5e-3, as the towers' fp32 bars).
- ``Block(act=)`` against ``plip_tpu.models.layers.transformer(act=)`` for
  every activation, forward and grads (allclose 1e-5); a ``"gelu"`` stack
  gives the same grads under every remat policy, ``"block"`` through the
  composed fallback (never K7); QuickGELU stays the default.
- The torchvision shapes: vit_b_32 S=50 and vit_b_16 S=197 at width 768 run
  K1's sublayer (``sublayer_path``); at 197 in fp32 the forward core is the
  one-block kernel and the backward the key-tiled one (``core_route``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import layers as jlayers
from plip_tpu.models import vit as jvit
from plip_tpu.models.config import VisionConfig as JVisionConfig
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.models import vit as tvit
from plip_tpu_torch.models.config import VisionConfig
from plip_tpu_torch.ops import attention as att
from plip_tpu_torch.ops import block_bwd as tblock


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {"port_vit_s5": dict(width=64, layers=2, heads=2, image_size=32, patch_size=16),
        "port_vit_s10": dict(width=64, layers=2, heads=2, image_size=48, patch_size=16)}


@pytest.fixture(scope="module", autouse=True)
def tiny_archs():
    for name, kw in TINY.items():
        jvit.ARCHS[name] = JVisionConfig(**kw)
        tvit.ARCHS[name] = VisionConfig(**kw)
    yield
    for name in TINY:
        jvit.ARCHS.pop(name, None)
        tvit.ARCHS.pop(name, None)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
    assert cos.min() > 0.9999, cos.min()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("arch", list(TINY))
def test_logits_and_grads_match_jax_kernels(monkeypatch, arch):
    cfg = tvit.ARCHS[arch]
    params = jax.device_get(jvit.init_params(jax.random.PRNGKey(0), arch, 3))
    model = tvit.ViTClassifier(arch, 3).load_jax_params(params)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    monkeypatch.setenv("PLIP_TPU_INTERPRET", "1")

    def f(p):
        return jnp.sum(jvit.forward(p, jnp.asarray(x), arch) * w)

    want_logits = np.asarray(jvit.forward(params, jnp.asarray(x), arch))
    want = tvit.flat_params(jax.device_get(jax.grad(f)(params)))
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and logits.shape == (4, 3)
    _close(logits.detach().numpy(), want_logits)
    (logits * torch.from_numpy(w)).sum().backward()
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        if name == "class_token" or not np.any(want[name]):
            np.testing.assert_allclose(p.grad.numpy(), want[name], atol=5e-3, err_msg=name)
        else:
            _close(p.grad.numpy()[None], want[name][None])


def _stack_pair(act, width=32, heads=2, layers=2, seed=0):
    """One JAX block stack (the LN parameters perturbed) and the port's
    ``Transformer`` holding it."""
    stacked = jax.device_get(jlayers.init_block_stack(jax.random.PRNGKey(seed), layers, width))
    rng = np.random.default_rng(seed)
    for ln in ("ln1", "ln2"):
        stacked[ln] = {"scale": rng.normal(1, 0.1, (layers, width)).astype(np.float32),
                       "bias": rng.normal(0, 0.1, (layers, width)).astype(np.float32)}
    model = tlayers.Transformer(width, layers, heads, False, 1e-6, act)
    model.load_state_dict(_stack_state(stacked))
    return stacked, model


def _stack_state(stacked):
    flat = tvit.flat_params({"blocks": stacked})
    return {k[len("blocks."):]: torch.tensor(v) for k, v in flat.items()}


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "relu"])
def test_block_act_matches_jax_transformer(act):
    stacked, model = _stack_pair(act)
    x = np.random.default_rng(2).standard_normal((3, 7, 32)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((3, 7, 32)).astype(np.float32)

    def f(xx, p):
        return jnp.sum(jlayers.transformer(xx, p, 2, eps=1e-6, act=act) * g)

    out_j = jlayers.transformer(jnp.asarray(x), stacked, 2, eps=1e-6, act=act)
    dx_j, dp_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), stacked)
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    want = _stack_state(jax.device_get(dp_j))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("remat", [True, "mlp", "mlp_h1", "block"])
def test_gelu_stack_under_every_remat(monkeypatch, remat):
    """Every remat policy gives the grads of ``remat=False`` for an exact-GELU
    stack; ``"block"`` takes the composed fallback (the JAX package's K7 gate
    refuses any activation but QuickGELU)."""
    _, model = _stack_pair("gelu", width=64, heads=2)
    assert all(b.act == "gelu" for b in model)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 5, 64)).astype(
        np.float32))
    assert tblock.uses_kernel(4, 5, 64, 256, 2, False)  # QuickGELU would take K7 here
    assert not tblock.uses_kernel(4, 5, 64, 256, 2, False, "gelu")
    monkeypatch.setattr(tblock, "BlockFn", None)  # K7's function is never reached

    def grads(r):
        model.zero_grad()
        xl = x.clone().requires_grad_()
        out = model(xl, r)
        out.square().sum().backward()
        return out.detach(), xl.grad, {n: p.grad.clone() for n, p in model.named_parameters()}

    (o0, dx0, g0), (o1, dx1, g1) = grads(False), grads(remat)
    torch.testing.assert_close(o1, o0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx1, dx0, rtol=1e-5, atol=1e-5)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-5, msg=k)


def test_act_defaults_and_refusal():
    assert tlayers.Block(32, 2).act == "quick_gelu"
    assert all(b.act == "quick_gelu" for b in tlayers.Transformer(32, 2, 2))
    with pytest.raises(ValueError, match="act="):
        tlayers.Block(32, 2, act="swish")
    vit = tvit.ViTClassifier("port_vit_s5", 3)
    assert all(b.act == "gelu" and b.eps == 1e-6 for b in vit.blocks)


def test_torchvision_shapes_take_k1_and_k2():
    for arch, S in (("vit_b_32", 50), ("vit_b_16", 197)):
        cfg = tvit.ARCHS[arch]
        assert cfg.seq_len == S and cfg.width == 768 and cfg.heads == 12
        assert tlayers.sublayer_path(S, cfg.width, False) == "attention_sublayer"
    assert att.core_route(197, 64, torch.float32) == "one_block"
    assert att.core_route(197, 64, torch.float32, backward=True) == "tiled"
    assert att.core_route(50, 64, torch.float32, backward=True) == "one_block"


def test_init_params_follow_the_jax_scheme():
    arch = "port_vit_s10"
    model = tvit.ViTClassifier(arch, 9).init_params(torch.Generator().manual_seed(0))
    params = jax.device_get(jvit.init_params(jax.random.PRNGKey(0), arch, 9))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in tvit.flat_params(params).items()}
    assert not model.class_token.any() and not model.head["bias"].any()
    again = tvit.ViTClassifier(arch, 9).init_params(torch.Generator().manual_seed(0))
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    for name, std in (("pos_embed", 0.02), ("head.kernel", 0.02),
                      ("patch_embed.kernel", 64 ** -0.5)):
        got = model.state_dict()[name].std().item()
        assert abs(got - std) < 0.15 * std, (name, got, std)
