"""The wider towers (ViT-B/16, ViT-L/14, ViT-L/14@336px) against the JAX
package, and the dispatch that picks their attention sublayer (CPU).

One JAX parameter tree goes into both packages (``from_jax_params``); the
same pixels and token ids, made with numpy from a seed, go through
``plip_tpu.models.clip.encode_image``/``encode_text`` and the port. Widths,
heads, patch and image sizes are the architectures' own; depth is cut to one
layer a tower and the vocabulary to 1,000 tokens to keep the CPU time small.
So the sequences are the real ones: S = 197 (B/16 vision, K1's widened core),
257 (L/14 vision, the composed sublayer over K3) and 577 (@336 vision, the
composed sublayer over K5); the L/14 text tower (W = 768, 12 heads, S = 77)
takes K1. Bars: fp32 row cosine > 0.9999 and allclose 5e-3; bf16 row cosine
>= 0.999. On the CPU the JAX towers take their composed path (``_jnp_mha``),
the port its plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.models import clip as jclip
from plip_tpu.models import config as jconfig
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models import clip as tclip
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.models import layers as tlayers
from plip_tpu_torch.ops import attention as T
from plip_tpu_torch.ops import mha as M
from plip_tpu_torch.utils.checkpoint import from_jax_params, save_checkpoint


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
ARCHS = ["ViT-B/16", "ViT-L/14", "ViT-L/14@336px"]
VOCAB = 1000


def _cut(cfgmod, arch, vocab_size=VOCAB):
    """The architecture at one layer a tower and a smaller vocabulary."""
    cfg = cfgmod.ARCHITECTURES[arch]()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, layers=1),
        text=dataclasses.replace(cfg.text, layers=1, vocab_size=vocab_size))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg, tcfg = _cut(jconfig, request.param), _cut(tconfig, request.param)
    params = jax.device_get(jclip.init_params(jax.random.PRNGKey(3), jcfg))
    model = tclip.CLIP(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    model.requires_grad_(False)
    v = tcfg.vision
    assert model.visual.pos_embed.shape == (v.seq_len, v.width)
    return request.param, params, jcfg, model, tcfg


def _row_cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_close(got, want, dtype):
    assert got.dtype == np.float32 and got.shape == want.shape
    cos = _row_cos(got, want).min()
    if dtype == "float32":
        assert cos > 0.9999, cos
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    else:
        assert cos >= 0.999, cos


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_image(pair, dtype):
    arch, params, jcfg, model, tcfg = pair
    tdt, jdt = DTYPES[dtype]
    n = tcfg.vision.image_size
    pixels = np.random.default_rng(0).standard_normal((2, n, n, 3)).astype(np.float32)
    want = np.asarray(jclip.encode_image(params, jnp.asarray(pixels), jcfg, jdt))
    got = model.encode_image(torch.from_numpy(pixels), tdt).numpy()
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_text(pair, dtype):
    arch, params, jcfg, model, tcfg = pair
    tdt, jdt = DTYPES[dtype]
    t = tcfg.text
    rng = np.random.default_rng(1)
    ids = np.zeros((2, t.context_length), np.int32)
    ids[:, 0] = t.vocab_size - 2
    ids[0, 1:9] = rng.integers(1, t.vocab_size - 2, 8)
    ids[0, 9] = ids[1, 20] = t.eot
    ids[1, 1:20] = rng.integers(1, t.vocab_size - 2, 19)
    want = np.asarray(jclip.encode_text(params, jnp.asarray(ids), jcfg, jdt))
    got = model.encode_text(torch.from_numpy(ids).long(), tdt).numpy()
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("S,W,remat,path", [
    (50, 768, False, "attention_sublayer"),    # ViT-B/32 vision
    (77, 768, False, "attention_sublayer"),    # L/14 text
    (197, 768, False, "attention_sublayer"),   # ViT-B/16 vision: K1 widened
    (128, 1024, False, "attention_sublayer"),  # the short-S gate holds at any width
    (129, 1024, False, "mha_core"),
    (257, 1024, False, "mha_core"),            # ViT-L/14 vision
    (512, 1024, False, "mha_core"),
    (513, 1024, False, "flash_core"),
    (577, 1024, False, "flash_core"),          # ViT-L/14@336px vision
    (257, 1024, "mlp", "hybrid"),              # ViT-L/14 training: K3 forward, K2 backward
    (129, 1024, True, "hybrid"),
    (512, 1024, "mlp", "hybrid"),
    (513, 1024, "mlp", "attention_sublayer"),  # the hybrid stops at 512
    (577, 1024, True, "attention_sublayer"),   # ViT-L/14@336px training: K1 and K2
    (577, 1024, "mlp", "attention_sublayer"),
    (197, 768, "mlp", "attention_sublayer"),   # ViT-B/16 training
    (128, 1024, "mlp", "attention_sublayer"),
])
def test_dispatch(S, W, remat, path):
    """Which core each (S, W, remat) takes, as the JAX package's transformer
    decides it; never by batch."""
    assert tlayers.sublayer_path(S, W, remat) == path


@pytest.mark.parametrize("arch,core", [("ViT-L/14", "mha_core"),
                                       ("ViT-L/14@336px", "flash_core")])
def test_composed_block_calls_its_core(arch, core, monkeypatch):
    """A wide vision block serving runs LN1, the qkv projection, the core the
    dispatch names and the out projection, with no K1 sublayer."""
    cfg = tconfig.ARCHITECTURES[arch]().vision
    block = tlayers.Block(cfg.width, cfg.heads)
    block.init_params(torch.Generator().manual_seed(0), cfg.layers)
    calls = []

    def spy(name, ref):
        def fn(qkv, S, heads, causal=False, *rest):
            calls.append((name, tuple(qkv.shape), S, heads, causal))
            return ref(qkv, S, heads, causal, *rest)
        return fn

    monkeypatch.setattr(tlayers, "mha_core", spy("mha_core", M.mha_core_reference))
    monkeypatch.setattr(tlayers, "flash_core", spy("flash_core", M.flash_core_reference))
    monkeypatch.setattr(tlayers, "attention_sublayer", None)
    x = torch.randn(1, cfg.seq_len, cfg.width)
    want = block.composed_attention(x, getattr(M, core + "_reference"))
    calls.clear()
    got = block(x)
    assert calls == [(core, (1, cfg.seq_len, 3 * cfg.width), cfg.seq_len, cfg.heads, False)]
    torch.testing.assert_close(got, block.mlp_half(want), rtol=0, atol=0)


def test_k2_keeps_its_own_limit():
    """K2's backward takes what K1's forward takes: every vision tower's S
    (197, 257, 577) at head_dim 64, ViT-H/14's head_dim 80 and head_dim 128
    past 128 tokens, up to the JAX package's flat bound of 1,056 tokens.
    Past it, it raises on the card before a launch; a head wider than 128
    takes the key-tiled kernels at every length."""
    from plip_tpu_torch.ops import attention_bwd as TB

    for S, W, heads in ((197, 768, 12), (257, 1024, 16), (577, 1024, 16),
                        (1056, 1024, 16), (128, 256, 2), (129, 256, 2), (257, 1280, 16)):
        T._check_geometry(2 * S, S, W, heads, None)
        TB._check_bwd_geometry(2 * S, S, W, heads, None)
    with pytest.raises(ValueError, match="attn_core_bwd takes S <= 1056"):
        TB._check_bwd_geometry(2 * 1057, 1057, 1024, 16, None)
    for S in (50, 129):  # head_dim 136, which raised before
        assert TB._check_bwd_geometry(2 * S, S, 272, 2, None) == "tiled"


@pytest.mark.parametrize("arch", ARCHS)
def test_plip_loads_every_architecture(arch, tmp_path):
    """``PLIP`` loads an .npz checkpoint of each wide architecture (cut to
    one layer; the real vocabulary, which the default tokenizer needs) and
    serves a request on the CPU: embeddings of the config's width, zero-shot
    labels and top-k retrieval, preprocessing at the config's image size."""
    cfg = _cut(tconfig, arch, tconfig.TextConfig.vocab_size)
    model = tclip.CLIP(cfg).init_params(torch.Generator().manual_seed(1))
    path = str(tmp_path / "wide.npz")
    save_checkpoint(path, model, cfg)
    plip = PLIP(path, device="cpu")
    assert plip.cfg == cfg
    n = cfg.vision.image_size
    images = list(np.random.default_rng(2).integers(0, 255, (3, n + 20, n, 3), np.uint8))
    img = plip.encode_images(images, batch_size=2)
    assert img.shape == (3, cfg.embed_dim) and np.isfinite(img).all()
    labels = plip.zero_shot_classification(images, ["tumor", "stroma"])
    assert len(labels) == 3 and set(labels) <= {"tumor", "stroma"}
    plip.build_image_index(images)
    assert plip.retrieval(["tumor"], top_k=2).shape == (1, 2)
