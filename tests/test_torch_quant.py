"""W8A8 serving in the port (``plip_tpu_torch.ops.quant``, ``PLIP(quantize=)``)
against ``plip_tpu.ops.quant`` and the JAX towers (CPU).

The cases of ``tests/test_quant.py``, held to the JAX package on the same
inputs: int8 weights, scales and activation integers exactly equal; the W8A8
linear allclose 1e-6 in fp32 and within one ulp in bf16; a tiny quantized
tower at the fp32 bars (row cosine > 0.9999, allclose 5e-3) and bf16's
(cosine >= 0.999), and within ``test_quant.py``'s 0.98 of the unquantized
tower. A quantized block takes the composed sublayer at every S and refuses
autograd. ``PLIP(quantize=)``: the validation, the width gate and the
visual-only quantization, on one-layer ``.npz`` files; a quantized model
saves only as ``.npz``, which both packages load back quantized.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.ops import quant as jquant
from plip_tpu.utils.checkpoint import load_checkpoint as jax_load
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models import layers
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.models.config import CLIPConfig as TConfig
from plip_tpu_torch.ops import attention as att
from plip_tpu_torch.ops import quant
from plip_tpu_torch.utils.checkpoint import from_jax_params, load_checkpoint


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("shape,scaled,bias", [((64, 32), None, True), ((16, 16), None, False),
                                               ((3, 8, 4), 1, False)])
def test_quantize_linear_equals_jax(shape, scaled, bias):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    if scaled is not None:
        w[scaled] *= 100.0  # one layer much larger: scales are per (layer, out channel)
    p = {"kernel": w}
    if bias:
        p["bias"] = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jquant.quantize_linear({k: jnp.asarray(v) for k, v in p.items()})
    got = quant.quantize_linear({k: torch.tensor(v) for k, v in p.items()})
    assert sorted(got) == sorted(want)
    assert got["kernel_q"].dtype == torch.int8 and got["wscale"].dtype == torch.float32
    assert tuple(got["wscale"].shape) == shape[:-2] + (1, shape[-1])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.fixture(scope="module")
def lin():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 96)) * 0.1).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    x[0, 0] = 0.0  # a zero row: the 1e-8 floor of its scale
    return (jquant.quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}),
            quant.quantize_linear({"kernel": torch.tensor(w), "bias": torch.tensor(b)}), x)


def test_activation_integers_equal_jax(lin):
    _, _, x = lin
    x32 = jnp.asarray(x)
    ascale = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-8)
    want = jnp.round(x32 / ascale).astype(jnp.int8)  # plip_tpu.ops.quant.linear_w8a8's
    xq, got_scale = quant.quantize_activations(torch.tensor(x))
    assert xq.dtype == torch.int8
    np.testing.assert_array_equal(xq.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_scale.numpy(), np.asarray(ascale))
    acc = quant.int8_mm(xq.reshape(-1, 64), lin[1]["kernel_q"])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want).reshape(-1, 64).astype(
        np.int64) @ np.asarray(lin[0]["kernel_q"]).astype(np.int64))


def test_linear_w8a8_fp32_matches_jax(lin):
    jp, tp, x = lin
    want = np.asarray(jquant.linear_w8a8(jnp.asarray(x), jp))
    got = quant.linear_w8a8(torch.tensor(x), tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_linear_w8a8_bf16_within_one_ulp(lin):
    jp, tp, x = lin
    want = np.asarray(jquant.linear_w8a8(jnp.asarray(x, jnp.bfloat16), jp).astype(jnp.float32))
    got = quant.linear_w8a8(torch.tensor(x).bfloat16(), tp)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


def test_linear_dispatches_on_kernel_q(lin):
    _, tp, x = lin
    xt = torch.tensor(x)
    torch.testing.assert_close(att.linear(xt, tp), quant.linear_w8a8(xt, tp), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a tiny tower through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers():
    cfg = CLIPConfig.tiny()  # vision width 64, 2 layers, S=5
    params = jax.device_get(jclip.init_params(jax.random.PRNGKey(0), cfg))
    qparams = {**params, "visual": {**params["visual"], "blocks": jquant.quantize_block_linears(
        params["visual"]["blocks"])}}
    model = CLIP(TConfig.tiny())
    model.load_state_dict(from_jax_params(params, model.cfg))
    model.requires_grad_(False)
    plain = CLIP(TConfig.tiny())
    plain.load_state_dict(model.state_dict())
    quant.quantize_block_linears(model.visual.blocks)
    rng = np.random.default_rng(3)
    px = rng.standard_normal((3, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(
        np.float32)
    return cfg, params, qparams, model, plain.requires_grad_(False), px


def test_quantized_blocks_equal_jax(towers):
    _, _, qparams, model, _, _ = towers
    jb = qparams["visual"]["blocks"]
    for i, block in enumerate(model.visual.blocks):
        for half, names in (("attn", ("qkv", "out")), ("mlp", ("fc1", "fc2"))):
            for n in names:
                p = getattr(block, half)[n]
                assert "kernel" not in p and not any(v.requires_grad for v in p.values())
                for k in ("kernel_q", "wscale", "bias"):
                    np.testing.assert_array_equal(p[k].numpy(), np.asarray(jb[half][n][k][i]))
    assert "kernel" in model.text.blocks[0].attn["qkv"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantized_tower_matches_jax(towers, dtype):
    cfg, params, qparams, model, plain, px = towers
    jd, td = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jclip.encode_image(qparams, jnp.asarray(px), cfg, dtype=jd), np.float32)
    with torch.inference_mode():
        got = model.encode_image(torch.tensor(px), td).float().numpy()
        unq = plain.encode_image(torch.tensor(px), td).float().numpy()
    cos = _cos_rows(got, want)
    if dtype == "fp32":
        assert cos.min() > 0.9999
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)
    else:
        assert cos.min() >= 0.999
    assert _cos_rows(got, unq).min() > 0.98  # test_quant.py's bar against the unquantized


def test_quantized_block_takes_the_composed_path(towers, monkeypatch):
    """S=5 <= 128, where an unquantized block takes K1's sublayer: the W8A8
    block runs the composed sublayer over mha_core instead."""
    _, _, _, model, plain, px = towers
    seen = []
    monkeypatch.setattr(layers, "attention_sublayer",
                        lambda *a, **k: seen.append("attention_sublayer"))
    real_core = layers.mha_core
    monkeypatch.setattr(layers, "mha_core", lambda *a: seen.append("mha_core") or real_core(*a))
    with torch.inference_mode():
        model.encode_image(torch.tensor(px))
    assert seen == ["mha_core"] * len(model.visual.blocks)
    assert layers.sublayer_path(px.shape[0], 64, False) == "attention_sublayer"
    big = torch.zeros(1, 600, 64)  # past 512 tokens: flash_core
    monkeypatch.setattr(layers, "flash_core", lambda *a: seen.append("flash_core") or a[0][
        ..., :64])
    with torch.inference_mode():
        model.visual.blocks[0](big)
    assert seen[-1] == "flash_core"


def test_quantized_tower_refuses_autograd_and_remat(towers):
    _, _, _, model, _, px = towers
    x = torch.tensor(px, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        model.encode_image(x)
    with pytest.raises(ValueError, match="remat"), torch.no_grad():
        model.encode_image(torch.tensor(px), remat="mlp")
    with torch.no_grad():  # no graph, no error
        assert torch.isfinite(model.encode_image(torch.tensor(px))).all()


# ---------------------------------------------------------------------------
# PLIP(quantize=)
# ---------------------------------------------------------------------------


def _npz(path, width, heads, seed):
    cfg = CLIPConfig(
        vision=VisionConfig(width=width, layers=1, heads=heads, image_size=224, patch_size=32),
        text=TextConfig(width=64, layers=1, heads=1, vocab_size=49408, context_length=77),
        embed_dim=32)
    jax_save(path, jclip.init_params(jax.random.PRNGKey(seed), cfg), cfg)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant")
    return {"narrow": _npz(str(d / "w64.npz"), 64, 1, 1),
            "wide": _npz(str(d / "w1024.npz"), 1024, 16, 2), "dir": d}


@pytest.fixture(scope="module")
def wide(ckpts):
    """The width-1024 model through both packages' PLIP(quantize="w8a8")."""
    return JPLIP(ckpts["wide"], quantize="w8a8"), PLIP(ckpts["wide"], device="cpu",
                                                      quantize="w8a8")


IMAGES = list(np.random.default_rng(5).integers(0, 256, (3, 240, 256, 3), dtype=np.uint8))
# At width 1024 one flipped activation integer moves an embedding by about
# 1e-2: relative noise of 1e-7 on the pixels moved the port's own embeddings
# by up to 9.4e-3 in one reading, and the two packages differ by 1.4e-2
# there (row cosine 0.99998). The tiny tower above takes allclose 5e-3; this
# one the cosine bar and this absolute bar.
WIDE_ATOL = 2e-2


def test_plip_quantize_warns_and_keeps_kernel_below_1024(ckpts):
    with pytest.warns(UserWarning, match="1024"):
        p = PLIP(ckpts["narrow"], device="cpu", quantize="w8a8")
    assert "kernel" in p.model.visual.blocks[0].attn["qkv"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = JPLIP(ckpts["narrow"], quantize="w8a8")
    assert "kernel" in j.params["visual"]["blocks"]["attn"]["qkv"]
    np.testing.assert_allclose(p.encode_images(IMAGES), j.encode_images(IMAGES),
                               rtol=5e-3, atol=5e-3)


def test_plip_quantize_rejects_an_unknown_mode_before_loading(monkeypatch):
    def load(*a):
        raise AssertionError("weights loaded before the mode was checked")

    monkeypatch.setattr(PLIP, "_load_model", staticmethod(load))
    with pytest.raises(ValueError, match="int4"):
        PLIP("random:ViT-B/32", device="cpu", quantize="int4")
    with pytest.raises(ValueError):
        JPLIP("random:ViT-B/32", quantize="int4")


def test_plip_quantizes_the_visual_blocks_only_at_1024(wide):
    j, p = wide
    for name in ("qkv", "out"):
        q = p.model.visual.blocks[0].attn[name]
        assert sorted(q) == ["bias", "kernel_q", "wscale"] and q["kernel_q"].dtype == torch.int8
        np.testing.assert_array_equal(q["kernel_q"].numpy(),
                                      np.asarray(j.params["visual"]["blocks"]["attn"][name][
                                          "kernel_q"][0]))
    for name in ("fc1", "fc2"):
        assert "kernel_q" in p.model.visual.blocks[0].mlp[name]
    text = p.model.text.blocks[0]
    assert "kernel" in text.attn["qkv"] and "kernel_q" not in text.mlp["fc1"]
    got, want = p.encode_images(IMAGES), j.encode_images(IMAGES)
    assert _cos_rows(got, want).min() > 0.9999
    np.testing.assert_allclose(got, want, rtol=0, atol=WIDE_ATOL)


def test_plip_save_of_a_quantized_model(wide, ckpts):
    """The JAX package writes a W8A8 model's .npz (kernel_q, wscale) and loads
    it back quantized; its torch namings raise KeyError 'kernel'. The port
    writes the same .npz, which both packages load back quantized, and
    refuses the torch namings with a ValueError."""
    j, p = wide
    d = ckpts["dir"]
    for fmt in ("openai", "hf"):
        with pytest.raises(KeyError, match="kernel"):
            j.save(str(d / f"j_{fmt}.pt"), format=fmt)
        with pytest.raises(ValueError, match="W8A8"):
            p.save(str(d / f"p_{fmt}.pt"), format=fmt)
    jpath, ppath = str(d / "jq.npz"), str(d / "pq.npz")
    j.save(jpath)
    p.save(ppath)
    jflat, pflat = np.load(jpath), np.load(ppath)
    assert sorted(jflat.files) == sorted(pflat.files)
    for k in jflat.files:
        assert jflat[k].dtype == pflat[k].dtype, k
        if k != "__config__":
            np.testing.assert_array_equal(jflat[k], pflat[k], err_msg=k)
    state, _ = load_checkpoint(jpath)
    assert state["visual.blocks.0.attn.qkv.kernel_q"].dtype == torch.int8
    want = p.encode_images(IMAGES)
    for path in (jpath, ppath):
        back = PLIP(path, device="cpu")
        assert "kernel_q" in back.model.visual.blocks[0].mlp["fc2"]
        np.testing.assert_array_equal(back.encode_images(IMAGES), want)
    jback, _ = jax_load(ppath)
    assert jback["visual"]["blocks"]["attn"]["qkv"]["kernel_q"].dtype == jnp.int8
