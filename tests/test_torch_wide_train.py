"""Training the wide towers against the JAX package (CPU): ViT-B/16, ViT-L/14
and ViT-L/14@336px at their real widths, heads and sequence lengths (197,
257, 577), one layer a tower, batch 2.

One JAX parameter tree goes into both packages (``from_jax_params``); the
same pixels and token ids, made with numpy from a seed, go through
``jax.value_and_grad(plip_tpu.train.contrastive.clip_loss)`` and the port's
``clip_loss`` + ``loss.backward()``, in fp32, under ``remat=False`` and
``"mlp"``. That drives every wide training path of the port
(``models.layers.sublayer_path``) through its plain versions: B/16 K1 with
K2; L/14 the hybrid (``"mlp"``: composed over K3 forward, K2 backward) and
the composed sublayer over K3 with K4 backward (``False``); @336 K1 with K2
at S = 577 (``"mlp"``) and the composed sublayer over K5 with the VJP of
``_jnp_mha`` (``False``). On the CPU the JAX package runs its composed XLA
path. Bars: loss rtol 2e-5; every grad leaf allclose with rtol 1e-4 and atol
5e-5 of the leaf's largest |value| (fp32 sums over up to 1,154 tokens of
2,304 to 4,096 columns, in another order in each package; the worst reading
here is 8.5e-6 of it), and leaf cosine > 0.99999.
"""

import functools

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
from plip_tpu_torch.train import contrastive as tc
from plip_tpu_torch.utils.checkpoint import from_jax_params, to_jax_params
from test_torch_wide import _cut


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["ViT-B/16", "ViT-L/14", "ViT-L/14@336px"]
REMATS = [False, "mlp"]
BATCH = 2


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n = cfg.vision.image_size
    px = rng.standard_normal((BATCH, n, n, 3)).astype(np.float32)
    ids = np.zeros((BATCH, cfg.text.context_length), np.int32)
    ids[:, 0] = cfg.text.vocab_size - 2
    ids[:, 1:12] = rng.integers(1, cfg.text.vocab_size - 2, (BATCH, 11))
    ids[0, 12] = ids[1, 30] = cfg.text.eot
    return px, ids


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """One parameter tree an architecture, for both remats."""
    return jax.device_get(jclip.init_params(jax.random.PRNGKey(4), _cut(jconfig, arch)))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, remat):
    jcfg = _cut(jconfig, arch)
    params = _jax_params(arch)
    px, ids = _batch(jcfg)

    def f(p):
        return jc.clip_loss(p, jnp.asarray(px), jnp.asarray(ids), jcfg, jnp.float32, remat)[0]

    loss, grads = jax.value_and_grad(f)(params)
    return params, float(loss), jax.device_get(grads)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_wide_train_step_matches_jax(arch, remat):
    params, loss_j, grads_j = _jax_run(arch, remat)
    tcfg = _cut(tconfig, arch)
    v = tcfg.vision
    paths = {tlayers.sublayer_path(v.seq_len, v.width, remat),
             tlayers.sublayer_path(tcfg.text.context_length, tcfg.text.width, remat)}
    want_paths = {("ViT-B/16", False): {"attention_sublayer"},
                  ("ViT-B/16", "mlp"): {"attention_sublayer"},
                  ("ViT-L/14", False): {"mha_core", "attention_sublayer"},
                  ("ViT-L/14", "mlp"): {"hybrid", "attention_sublayer"},
                  ("ViT-L/14@336px", False): {"flash_core", "attention_sublayer"},
                  ("ViT-L/14@336px", "mlp"): {"attention_sublayer"}}
    assert paths == want_paths[arch, remat]
    model = tclip.CLIP(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    px, ids = _batch(tcfg)
    loss_t, _ = tc.clip_loss(model, torch.from_numpy(px), torch.from_numpy(ids).long(),
                             torch.float32, remat)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), loss_j, rtol=2e-5)
    got = _leaves(to_jax_params({k: p.grad for k, p in model.named_parameters()}, tcfg))
    want = _leaves(grads_j)
    assert got.keys() == want.keys()
    for k, b in want.items():
        a = got[k]
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5 * scale, err_msg=k)
        if scale > 0:
            cos = float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.99999, (k, cos)
