"""The port's CLIP towers against ``plip_tpu.models.clip`` (CPU).

One JAX parameter tree goes into both packages (``from_jax_params``); the
same pixels and token ids, made with numpy from a seed, go through both.
Bars: fp32 row cosine > 0.9999 and allclose 5e-3 (the bars the JAX towers
are held to against HF); bf16 row cosine >= 0.999. On the CPU the JAX towers
take the composed attention path, the port its plain sublayer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu_torch.models import clip as tclip
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _b32_two_layers(cfgmod):
    return cfgmod.CLIPConfig(
        vision=cfgmod.VisionConfig(width=768, layers=2, heads=12),
        text=cfgmod.TextConfig(width=512, layers=2, heads=8))


CONFIGS = {"tiny": lambda m: m.CLIPConfig.tiny(), "b32_2layer": _b32_two_layers}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg, tcfg = CONFIGS[request.param](jconfig), CONFIGS[request.param](tconfig)
    params = jax.device_get(jclip.init_params(jax.random.PRNGKey(1), jcfg))
    model = tclip.CLIP(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    model.requires_grad_(False)
    return params, jcfg, model, tcfg


def _inputs(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text
    pixels = rng.standard_normal((B, v.image_size, v.image_size, 3)).astype(np.float32)
    ids = np.zeros((B, t.context_length), np.int32)
    for b in range(B):
        n = 3 + 4 * b
        ids[b, 0] = t.vocab_size - 2  # SOT
        ids[b, 1:n] = rng.integers(1, t.vocab_size - 2, n - 1)
        ids[b, n] = t.eot
    ids[0, 8] = t.eot  # a second EOT: pooling takes the first
    return pixels, ids


def _row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_close(got, want, dtype):
    cos = _row_cos(got, want).min()
    if dtype == "float32":
        assert cos > 0.9999, cos
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    else:
        assert cos >= 0.999, cos


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_image(pair, dtype):
    params, jcfg, model, tcfg = pair
    tdt, jdt = DTYPES[dtype]
    pixels, _ = _inputs(tcfg)
    want = np.asarray(jclip.encode_image(params, jnp.asarray(pixels), jcfg, jdt))
    got = model.encode_image(torch.from_numpy(pixels), tdt).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_text(pair, dtype):
    params, jcfg, model, tcfg = pair
    tdt, jdt = DTYPES[dtype]
    _, ids = _inputs(tcfg)
    want = np.asarray(jclip.encode_text(params, jnp.asarray(ids), jcfg, jdt))
    got = model.encode_text(torch.from_numpy(ids).long(), tdt).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("logit_scale", [None, 5.0])
def test_forward(pair, logit_scale):
    """Logits, including the clamp of a logit scale above its ceiling."""
    params, jcfg, model, tcfg = pair
    if logit_scale is not None:
        params = {**params, "logit_scale": np.float32(logit_scale)}
        model.logit_scale.fill_(logit_scale)
    pixels, ids = _inputs(tcfg, B=3, seed=1)
    want_i, want_t = jclip.forward(params, jnp.asarray(pixels), jnp.asarray(ids), jcfg)
    got_i, got_t = model(torch.from_numpy(pixels), torch.from_numpy(ids).long())
    model.logit_scale.fill_(tcfg.logit_scale_init)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_i).T, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(want_t), np.asarray(want_i).T)


def test_patchify_matches_jax():
    x = np.arange(2 * 64 * 64 * 3, dtype=np.float32).reshape(2, 64, 64, 3)
    want = np.asarray(jclip.patchify(jnp.asarray(x), 32))
    np.testing.assert_array_equal(tclip.patchify(torch.from_numpy(x), 32).numpy(), want)


def test_l2_normalize_keeps_zero_rows():
    x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    np.testing.assert_allclose(tclip.l2_normalize(x).numpy(), [[0, 0], [0.6, 0.8]])


def test_init_params_shapes_and_seed():
    """A seeded init has the JAX tree's structure, shapes and scale, and the
    same seed gives the same weights."""
    tcfg, jcfg = tconfig.CLIPConfig.tiny(), jconfig.CLIPConfig.tiny()
    a = tclip.CLIP(tcfg).init_params(torch.Generator().manual_seed(3))
    b = tclip.CLIP(tcfg).init_params(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    want = jax.device_get(jclip.init_params(jax.random.PRNGKey(0), jcfg))
    got = to_jax_params(a, tcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.size > 1000:  # the random matrices: same std within sampling error
            assert abs(g.std() / w.std() - 1) < 0.1


def test_jax_params_roundtrip():
    jcfg, tcfg = jconfig.CLIPConfig.tiny(), tconfig.CLIPConfig.tiny()
    want = jax.device_get(jclip.init_params(jax.random.PRNGKey(2), jcfg))
    got = to_jax_params(from_jax_params(want, tcfg), tcfg)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    bad = tconfig.CLIPConfig(vision=tconfig.VisionConfig(width=64, layers=3, heads=4,
                                                          image_size=32, patch_size=16),
                             text=tcfg.text, embed_dim=24)
    with pytest.raises(ValueError, match="stacked layers"):
        from_jax_params(want, bad)
