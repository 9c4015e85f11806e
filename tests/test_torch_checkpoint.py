"""The port's torch state_dicts, its two checkpoint CLIs and
``encode_images(decode_mode=)`` against the JAX package (CPU).

One parameter tree of a tiny config, drawn by the JAX package from a seed,
is written as OpenAI- and HF-named state_dicts; every converter of
``plip_tpu_torch.utils.checkpoint`` is held to its counterpart in
``plip_tpu.utils.checkpoint`` on the same dicts, leaves exactly equal. The
towers against ``transformers.CLIPModel`` and the port's ``PLIP`` against
the JAX one take the fp32 bars: row cosine > 0.9999 and allclose 5e-3.
"""

import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.scripts.export_checkpoint import main as jax_export
from plip_tpu.scripts.import_checkpoint import main as jax_import
from plip_tpu.utils import checkpoint as J
from plip_tpu_torch import native
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.models import config as tconfig
from plip_tpu_torch.models.clip import CLIP
from plip_tpu_torch.scripts.export_checkpoint import main as port_export
from plip_tpu_torch.scripts.import_checkpoint import main as port_import
from plip_tpu_torch.train.clip_tuner import CLIPTuner
from plip_tpu_torch.utils import checkpoint as T

NAMINGS = ("openai", "hf")


def _cfg():
    # widths are multiples of 64: a bare state_dict gives heads = width // 64;
    # 224 px and the real vocabulary, so PLIP's preprocessing and tokenizer run
    return CLIPConfig(
        vision=VisionConfig(width=128, layers=2, heads=2, image_size=224, patch_size=32),
        text=TextConfig(width=64, layers=2, heads=1, vocab_size=49408, context_length=77),
        embed_dim=24)


@pytest.fixture(scope="module")
def jax_params():
    cfg = _cfg()
    return jax.device_get(jclip.init_params(jax.random.PRNGKey(7), cfg)), cfg


@pytest.fixture(scope="module")
def dicts(jax_params):
    params, cfg = jax_params
    return {"openai": J.to_openai_sd(params, cfg), "hf": J.to_hf_sd(params, cfg)}


@pytest.fixture(scope="module")
def files(jax_params, tmp_path_factory):
    """The tiny model as a native .npz and as torch files in both namings,
    all written by the JAX package."""
    params, cfg = jax_params
    d = tmp_path_factory.mktemp("ckpt")
    out = {"npz": str(d / "tiny.npz")}
    J.save_checkpoint(out["npz"], params, cfg)
    for naming in NAMINGS:
        out[naming] = J.save_torch_checkpoint(str(d / f"tiny_{naming}.pt"), params, cfg,
                                              naming=naming)
    return out


def _flat(tree):
    return J._flatten(jax.device_get(tree))


def _assert_same_params(state, cfg, params, jcfg):
    """A port (state_dict, config) equals a JAX (params, config), leaf for leaf."""
    assert T.cfg_to_json(cfg) == J.cfg_to_json(jcfg)
    got, want = _flat(T.to_jax_params(state, cfg)), _flat(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos.min()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


# ---- the converters ---------------------------------------------------------


@pytest.mark.parametrize("naming", NAMINGS)
def test_import_matches_jax(dicts, jax_params, naming):
    port_fn = {"openai": T.from_openai_clip, "hf": T.from_hf_clip}[naming]
    jax_fn = {"openai": J.from_openai_clip, "hf": J.from_hf_clip}[naming]
    state, cfg = port_fn(dicts[naming])
    want, jcfg = jax_fn(dicts[naming])
    _assert_same_params(state, cfg, want, jcfg)
    _assert_same_params(state, cfg, *jax_params)
    CLIP(cfg).load_state_dict(state)  # every key, every shape


@pytest.mark.parametrize("naming", NAMINGS)
def test_export_matches_jax(jax_params, naming):
    params, jcfg = jax_params
    cfg = T.cfg_from_json(J.cfg_to_json(jcfg))
    state = T.from_jax_params(params, cfg)
    port_fn = {"openai": T.to_openai_sd, "hf": T.to_hf_sd}[naming]
    jax_fn = {"openai": J.to_openai_sd, "hf": J.to_hf_sd}[naming]
    want = jax_fn(params, jcfg)
    _assert_same_dicts(port_fn(state, cfg), want)
    model = CLIP(cfg)
    model.load_state_dict(state)
    _assert_same_dicts(port_fn(model, cfg), want)  # a CLIP is taken as its state_dict


def test_rekeyers_match_jax(dicts):
    _assert_same_dicts(T.openai_sd_to_hf_sd(dicts["openai"]),
                       J.openai_sd_to_hf_sd(dicts["openai"]))
    _assert_same_dicts(T.hf_sd_to_openai_sd(dicts["hf"]), J.hf_sd_to_openai_sd(dicts["hf"]))
    torch_dict = {k: torch.tensor(v) for k, v in dicts["hf"].items()}
    _assert_same_dicts(T.openai_sd_to_hf_sd(T.hf_sd_to_openai_sd(torch_dict)), dicts["hf"])


@pytest.mark.parametrize("naming", NAMINGS)
def test_round_trip_is_bit_exact(jax_params, naming):
    params, jcfg = jax_params
    cfg = T.cfg_from_json(J.cfg_to_json(jcfg))
    state = T.from_jax_params(params, cfg)
    export = {"openai": T.to_openai_sd, "hf": T.to_hf_sd}[naming]
    back, cfg2 = T.from_torch_state_dict(export(state, cfg))
    assert cfg2 == cfg and set(back) == set(state)
    for k in state:
        assert back[k].shape == state[k].shape, k
        assert torch.equal(back[k], state[k]), k


@pytest.mark.parametrize("naming", NAMINGS)
def test_torch_files_load_in_either_package(files, jax_params, tmp_path, naming):
    params, jcfg = jax_params
    state, cfg = T.load_torch_checkpoint(files[naming])  # written by the JAX package
    _assert_same_params(state, cfg, params, jcfg)
    path = T.save_torch_checkpoint(str(tmp_path / "port.pt"), state, cfg, naming=naming)
    got, got_cfg = J.load_torch_checkpoint(path)
    assert got_cfg == jcfg
    _assert_same_params(state, cfg, got, got_cfg)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    assert saved["logit_scale"].shape == ()  # the parameter's own shape
    with pytest.raises(ValueError, match="naming must be"):
        T.save_torch_checkpoint(str(tmp_path / "x.pt"), state, cfg, naming="ggml")


@pytest.mark.parametrize("naming", NAMINGS)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_precision_state_dicts(dicts, naming, dtype):
    """Every floating tensor goes to fp32 on the torch side, so a bf16 dict
    loads and gives what its fp32 upcast gives in the JAX package. (The JAX
    package's own import calls ``.numpy()`` on the bf16 tensor and raises.)"""
    half = {k: torch.tensor(v).to(dtype)
            for k, v in dicts[naming].items()}
    state, cfg = T.from_torch_state_dict(half)
    want, jcfg = J.from_torch_state_dict({k: v.float() for k, v in half.items()})
    _assert_same_params(state, cfg, want, jcfg)
    assert all(v.dtype == torch.float32 for v in state.values())
    if dtype == torch.bfloat16:
        with pytest.raises(TypeError, match="BFloat16"):
            J.from_torch_state_dict(half)


def test_naming_is_told_by_a_key_only_it_has(dicts, jax_params, tmp_path):
    """The port's own ``CLIP`` state_dict starts with ``visual.`` too; it is
    refused with the JAX package's message and a pointer to ``.npz``, not
    read as OpenAI naming."""
    params, jcfg = jax_params
    own = T.from_jax_params(params, T.cfg_from_json(J.cfg_to_json(jcfg)))
    assert "visual.class_embedding" in own
    for bad in (own, {"visual.proj": torch.zeros(2, 2)}, {"foo": torch.zeros(1)}):
        with pytest.raises(ValueError, match=r"Unrecognized state_dict naming.*\.npz"):
            T.from_torch_state_dict(bad)
    path = str(tmp_path / "own.pt")
    torch.save(own, path)
    with pytest.raises(ValueError, match="Unrecognized state_dict naming"):
        PLIP(path, device="cpu")
    for naming in NAMINGS:  # each naming is read by its own converter
        _, cfg = T.from_torch_state_dict(dicts[naming])
        assert T.cfg_to_json(cfg) == J.cfg_to_json(jcfg)


def test_towers_hold_to_hf_clipmodel(jax_params):
    """``transformers.CLIPModel`` built from the config (no download), loaded
    with the port's ``to_hf_sd``, against the port's towers."""
    transformers = pytest.importorskip("transformers")
    params, jcfg = jax_params
    cfg = T.cfg_from_json(J.cfg_to_json(jcfg))
    model = CLIP(cfg)
    model.load_state_dict(T.from_jax_params(params, cfg))
    hf = transformers.CLIPModel(transformers.CLIPConfig(
        vision_config=dict(hidden_size=cfg.vision.width, num_hidden_layers=cfg.vision.layers,
                           num_attention_heads=cfg.vision.heads,
                           intermediate_size=cfg.vision.width * 4,
                           image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size),
        text_config=dict(hidden_size=cfg.text.width, num_hidden_layers=cfg.text.layers,
                         num_attention_heads=cfg.text.heads,
                         intermediate_size=cfg.text.width * 4,
                         vocab_size=cfg.text.vocab_size,
                         max_position_embeddings=cfg.text.context_length),
        projection_dim=cfg.embed_dim)).eval()
    sd = {k: torch.tensor(v) for k, v in T.to_hf_sd(model, cfg).items()}
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and all("position_ids" in k for k in missing), missing

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    ids = np.zeros((2, 77), np.int64)  # pooled at the first EOT (49407) in both
    ids[:, 0] = 49406
    ids[0, 1:4] = [320, 1125, 539]
    ids[0, 4] = 49407
    ids[1, 1:3] = [1000, 2000]
    ids[1, 3] = 49407
    with torch.no_grad():
        want_img = hf.get_image_features(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2))).numpy()
        want_txt = hf.get_text_features(input_ids=torch.from_numpy(ids)).numpy()
        got_img = model.encode_image(torch.from_numpy(pixels)).numpy()
        got_txt = model.encode_text(torch.from_numpy(ids)).numpy()
    _assert_close(got_img, want_img)
    _assert_close(got_txt, want_txt)


# ---- PLIP and CLIPTuner --------------------------------------------------------


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(3)]


@pytest.mark.parametrize("naming", NAMINGS)
def test_plip_loads_torch_files_as_jax(files, arrays, naming, monkeypatch):
    """``PLIP(path)`` on a torch file in either naming answers as the JAX
    ``PLIP(path)`` on the same file; ``PLIP_TPU_CHECKPOINT`` finds it too."""
    jm, tm = JPLIP(files[naming]), PLIP(files[naming], device="cpu")
    _assert_close(tm.encode_images(arrays, batch_size=2), jm.encode_images(arrays, batch_size=2))
    texts = ["an H&E image of benign tissue", "an H&E image of tumor"]
    _assert_close(tm.encode_text(texts), jm.encode_text(texts))
    monkeypatch.setenv("PLIP_TPU_CHECKPOINT", files[naming])
    env = PLIP("not-a-file", device="cpu")
    for k, v in tm.model.state_dict().items():
        assert torch.equal(env.model.state_dict()[k], v), k


@pytest.mark.parametrize("fmt", NAMINGS)
def test_plip_save_formats(files, jax_params, tmp_path, fmt):
    """``save(format="openai"|"hf")`` writes a torch file that loads back
    into the port and into the JAX package with the same parameters."""
    params, jcfg = jax_params
    tm = PLIP(files["npz"], device="cpu")
    path = tm.save(str(tmp_path / f"tuned_{fmt}.pt"), format=fmt)
    got, got_cfg = J.load_torch_checkpoint(path)
    assert got_cfg == jcfg
    _assert_same_params(tm.model.state_dict(), tm.cfg, got, got_cfg)
    _assert_same_params(tm.model.state_dict(), tm.cfg, params, jcfg)
    back = PLIP(path, device="cpu")
    assert back.cfg == tm.cfg
    for k, v in tm.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="format must be 'npz', 'openai' or 'hf'"):
        tm.save(str(tmp_path / "x.bin"), format="ggml")


@pytest.mark.parametrize("naming", NAMINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_tuner_backbone_takes_torch_files(dicts, jax_params, tmp_path, naming, dtype):
    params, jcfg = jax_params
    path = str(tmp_path / "backbone.pt")
    torch.save({k: torch.tensor(v).to(dtype)
                for k, v in dicts[naming].items()}, path)
    tuner = CLIPTuner(backbone=path, device="cpu")
    want, wcfg = J.from_torch_state_dict(
        {k: torch.tensor(v).to(dtype).float()
         for k, v in dicts[naming].items()})
    _assert_same_params(tuner.model.state_dict(), tuner.cfg, want, wcfg)
    plip = PLIP(path, device="cpu")
    for k, v in tuner.model.state_dict().items():
        assert torch.equal(plip.model.state_dict()[k], v), k


def test_tuner_validation_at_336(tmp_path):
    """``valid_evaluation`` of a one-layer ViT-L/14@336px tuner preprocesses
    at 336 (the JAX tuner preprocesses at 224 and fails on the position
    table): the loss is the InfoNCE of the batch preprocessed at 336."""
    from plip_tpu_torch.ops.preprocess import preprocess_images
    from plip_tpu_torch.train.contrastive import clip_loss

    full = tconfig.CLIPConfig.vit_l14_336()
    cfg = tconfig.CLIPConfig(
        vision=tconfig.VisionConfig(width=full.vision.width, layers=1, heads=full.vision.heads,
                                    image_size=336, patch_size=14),
        text=tconfig.TextConfig(width=full.text.width, layers=1, heads=full.text.heads),
        embed_dim=full.embed_dim)
    model = CLIP(cfg).init_params(torch.Generator().manual_seed(0))
    path = T.save_torch_checkpoint(str(tmp_path / "l14_336.pt"), model, cfg)
    tuner = CLIPTuner(backbone=path, device="cpu", px_size=336)
    assert tuner.cfg == cfg
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (356, 336, 3), dtype=np.uint8) for _ in range(2)]
    captions = ["an H&E image of tumor", "an H&E image of stroma"]
    loss = tuner.valid_evaluation([((images, captions), 2)])
    ids = torch.as_tensor(tuner.tokenizer.tokenize(captions, 77), dtype=torch.long)
    with torch.no_grad():
        want, _ = clip_loss(tuner.model, preprocess_images(images, 336), ids, torch.float32)
    assert np.isfinite(loss) and loss == pytest.approx(float(want), rel=1e-6)


# ---- the CLIs ---------------------------------------------------------------------


TINY_HF = dict(
    text_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                     vocab_size=49408, max_position_embeddings=77, intermediate_size=256,
                     hidden_act="quick_gelu"),
    vision_config=dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                       image_size=32, patch_size=16, intermediate_size=512,
                       hidden_act="quick_gelu"),
    projection_dim=24)


@pytest.fixture(scope="module")
def hf_weights(tmp_path_factory):
    """A tiny ``transformers.CLIPModel``'s state_dict as a torch file in HF
    and in OpenAI naming, and as ``.safetensors``."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(7)
    sd = transformers.CLIPModel(transformers.CLIPConfig(**TINY_HF)).eval().state_dict()
    d = tmp_path_factory.mktemp("weights")
    out = {"hf": str(d / "pytorch_model.bin"), "openai": str(d / "plip_openai.pt")}
    torch.save(sd, out["hf"])
    torch.save({k: torch.tensor(v)
                for k, v in J.hf_sd_to_openai_sd(sd).items()}, out["openai"])
    st = pytest.importorskip("safetensors.torch")
    out["safetensors"] = str(d / "model.safetensors")
    st.save_file({k: v.contiguous() for k, v in sd.items()}, out["safetensors"])
    return out


def _golden_close(got_path, want_path):
    got, want = np.load(got_path), np.load(want_path)
    assert set(got.files) == set(want.files)
    for k in ("checkpoint", "pixels", "input_ids", "threshold"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("image_embeddings", "text_embeddings"):
        _assert_close(got[k], want[k])
    for k in ("min_cosine_image", "min_cosine_text"):
        assert float(got[k]) > 0.999 and float(want[k]) > 0.999


def _npz_equal(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert set(x.files) == set(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("src", ["hf", "openai", "safetensors"])
def test_import_cli_matches_jax(hf_weights, tmp_path, src, capsys):
    """Both importers on one file: the same summary, the same ``model.npz``
    and golden fixtures that agree (the port's towers on the CPU)."""
    got = port_import([hf_weights[src], "--out", str(tmp_path / "port"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_import([hf_weights[src], "--out", str(tmp_path / "jax")])
    assert printed == json.loads(json.dumps(got))
    assert got["verified"] and got["min_cosine_image"] > 0.999 and got["min_cosine_text"] > 0.999
    assert {k: v for k, v in got.items() if k not in ("checkpoint", "golden") and "cos" not in k} \
        == {k: v for k, v in want.items() if k not in ("checkpoint", "golden") and "cos" not in k}
    _npz_equal(got["checkpoint"], want["checkpoint"])
    _golden_close(got["golden"], want["golden"])


def test_import_cli_vocab_and_npz(hf_weights, tmp_path):
    from plip_tpu_torch.tokenizer import save_hf_format, synthetic_vocab

    tok = synthetic_vocab()
    vocab = str(tmp_path / "vocab")
    save_hf_format(tok, vocab)
    got = port_import([hf_weights["hf"], "--vocab", vocab, "--out", str(tmp_path / "p"),
                       "--device", "cpu"])
    want = jax_import([hf_weights["hf"], "--vocab", vocab, "--out", str(tmp_path / "j")])
    assert got["vocab"] is not None and len(got["vocab"]) == len(want["vocab"])
    _golden_close(got["golden"], want["golden"])
    with np.load(got["golden"]) as g:
        assert (g["input_ids"] == tok.eot_token).any(axis=1).all()
    with pytest.raises(ValueError, match="vocab size"):
        bad = str(tmp_path / "bad")
        save_hf_format(synthetic_vocab(total_size=49000), bad)
        port_import([hf_weights["hf"], "--vocab", bad, "--out", str(tmp_path / "b"),
                     "--device", "cpu"])
    with pytest.raises(ValueError, match="--skip-verify required"):
        port_import([got["checkpoint"], "--out", str(tmp_path / "n"), "--device", "cpu"])
    again = port_import([got["checkpoint"], "--out", str(tmp_path / "n"), "--device", "cpu",
                         "--skip-verify"])
    _npz_equal(again["checkpoint"], got["checkpoint"])
    with pytest.raises(AssertionError, match="fidelity"):
        port_import([hf_weights["hf"], "--out", str(tmp_path / "t"), "--device", "cpu",
                     "--threshold", "1.1"])


def test_import_cli_without_transformers_names_skip_verify(hf_weights, tmp_path,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises ImportError
    with pytest.raises(RuntimeError, match="--skip-verify"):
        port_import([hf_weights["openai"], "--out", str(tmp_path / "x"), "--device", "cpu"])
    got = port_import([hf_weights["openai"], "--out", str(tmp_path / "y"), "--device", "cpu",
                       "--skip-verify"])
    assert not got["verified"] and np.isnan(got["min_cosine_image"])


def test_import_cli_loads_torch_files_safely(hf_weights, tmp_path):
    """Plain state_dicts load under torch's ``weights_only=True``; a pickled
    whole module is refused with a message naming the file and
    ``--allow-pickle``, and with the flag gives the plain dict's import."""
    transformers = pytest.importorskip("transformers")
    from plip_tpu_torch.scripts.import_checkpoint import _load_state_dict

    for src in ("hf", "openai"):
        safe = torch.load(hf_weights[src], map_location="cpu", weights_only=True)
        got = _load_state_dict(hf_weights[src])
        assert got.keys() == safe.keys() and all(torch.equal(got[k], safe[k]) for k in got)
    module = transformers.CLIPModel(transformers.CLIPConfig(**TINY_HF)).eval()
    module.load_state_dict(torch.load(hf_weights["hf"], map_location="cpu", weights_only=True))
    path = str(tmp_path / "module.pt")
    torch.save(module, path)
    with pytest.raises(ValueError, match="module.pt.*--allow-pickle"):
        port_import([path, "--out", str(tmp_path / "m"), "--device", "cpu", "--skip-verify"])
    got = port_import([path, "--out", str(tmp_path / "m"), "--device", "cpu", "--skip-verify",
                       "--allow-pickle"])
    want = port_import([hf_weights["hf"], "--out", str(tmp_path / "h"), "--device", "cpu",
                        "--skip-verify"])
    _npz_equal(got["checkpoint"], want["checkpoint"])


@pytest.mark.parametrize("naming", NAMINGS)
def test_export_cli_matches_jax(files, tmp_path, naming, capsys):
    got = port_export([files["npz"], str(tmp_path / "port.pt"), "--naming", naming,
                       "--device", "cpu"])
    assert capsys.readouterr().out.strip() == f"wrote {naming} state_dict: {got}"
    want = jax_export([files["npz"], str(tmp_path / "jax.pt"), "--naming", naming])
    a = torch.load(got, map_location="cpu", weights_only=True)
    b = torch.load(want, map_location="cpu", weights_only=True)
    assert set(a) == set(b)
    for k in b:  # the JAX file stores logit_scale as [1], the port as its own []
        assert torch.equal(a[k], b[k].reshape(a[k].shape)), k
    state, cfg = T.load_torch_checkpoint(got)
    _assert_same_params(state, cfg, *J.load_checkpoint(files["npz"]))
    with pytest.raises(NotImplementedError, match="item 9"):
        port_export([str(tmp_path), str(tmp_path / "x.pt"), "--device", "cpu"])


def _port_replay(path):
    """The port's replay of a golden fixture: its fp32 towers on the probe
    inputs against the stored embeddings (the JAX replay's bars)."""
    data = np.load(path, allow_pickle=False)
    model, _ = T.load_any_checkpoint(os.path.join(os.path.dirname(path),
                                                  str(data["checkpoint"])))
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(data["pixels"])).numpy()
        txt = model.encode_text(torch.from_numpy(data["input_ids"]).long()).numpy()
    for got, want in ((img, data["image_embeddings"]), (txt, data["text_embeddings"])):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) *
                                      np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.9999


def test_golden_fixtures_replay_across_packages(hf_weights, tmp_path, monkeypatch):
    from tests.test_golden_embeddings import _check_fixture, _fixture_files

    port = port_import([hf_weights["openai"], "--out", str(tmp_path / "p"),
                        "--device", "cpu"])
    jax_ = jax_import([hf_weights["openai"], "--out", str(tmp_path / "j")])
    monkeypatch.setenv("PLIP_TPU_GOLDEN_DIR", str(tmp_path / "p"))
    assert port["golden"] in _fixture_files()
    _check_fixture(port["golden"])  # the JAX package replays the port's fixture
    _port_replay(jax_["golden"])  # and the port the JAX package's
    _port_replay(port["golden"])


def _golden_files():
    d = os.environ.get("PLIP_TPU_GOLDEN_DIR")
    if not d or not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".golden.npz"))


@pytest.mark.parametrize("path", _golden_files() or [None])
def test_golden_embeddings_in_port(path):
    """Fixtures under ``PLIP_TPU_GOLDEN_DIR`` (either package's importer)
    replay in the port; with none on disk this skips, as the JAX test does."""
    if path is None:
        pytest.skip("no golden fixtures on disk: run "
                    "`python -m plip_tpu_torch.scripts.import_checkpoint` on real weights")
    _port_replay(path)


def test_safetensors_reader(tmp_path):
    """The port reads ``.safetensors`` itself (the card has no safetensors
    package); held against ``safetensors``' own readers."""
    stn = pytest.importorskip("safetensors.numpy")
    stt = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float16),
              "c": rng.integers(-9, 9, (2, 2, 3)).astype(np.int64),
              "d": np.array(2.5), "e": rng.integers(0, 255, (4,)).astype(np.uint8)}
    path = str(tmp_path / "n.safetensors")
    stn.save_file(arrays, path, metadata={"format": "np"})
    got, want = T.load_safetensors(path), stn.load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    tensors = {"w": torch.randn(4, 6).to(torch.bfloat16), "x": torch.randn(3)}
    path = str(tmp_path / "t.safetensors")
    stt.save_file(tensors, path)
    got, want = T.load_safetensors(path), stt.load_file(path)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


# ---- decode_mode ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Two 224x224 JPEGs (the fast lane decodes them as they are) and two of
    300x400 (it resamples them: status 1)."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(3)
    paths = []
    for i, (h, w) in enumerate(((224, 224), (300, 400), (224, 224), (300, 400))):
        p = str(d / f"t{i}.jpg")
        base = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
        Image.fromarray(np.kron(base, np.ones((8, 8, 1), np.uint8))).save(p, quality=92)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def plips(files):
    return JPLIP(files["npz"]), PLIP(files["npz"], device="cpu")


@pytest.mark.parametrize("mode", ["fast", "fast_approx", "exact", "something-else"])
def test_decode_modes_match_jax(plips, jpegs, mode):
    """Each mode against the JAX package's, in batches of 2 (two batches with
    a resampled slot); ``fast_approx`` warns once a call in both packages."""
    if not native.available():
        pytest.skip("the native decode pool did not build here")
    jm, tm = plips
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jm.encode_images(jpegs, batch_size=2, decode_mode=mode)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tm.encode_images(jpegs, batch_size=2, decode_mode=mode)
    _assert_close(got, want)
    jmsg = [str(w.message) for w in jw if "fast_approx" in str(w.message)]
    tmsg = [str(w.message) for w in tw if "fast_approx" in str(w.message)]
    assert tmsg == jmsg and len(tmsg) == (mode == "fast_approx")
    if mode not in ("fast", "fast_approx"):  # any other value takes the exact path
        exact = tm.encode_images(jpegs, batch_size=2, decode_mode="exact")
        np.testing.assert_array_equal(got, exact)


def test_decode_modes_differ_only_where_resampled(plips, jpegs):
    """On the 224x224 JPEGs every mode gives the same embedding; on the
    300x400 ones ``fast`` (PIL's bicubic) and ``fast_approx`` (the native
    approximation) differ from each other and from ``exact``."""
    if not native.available():
        pytest.skip("the native decode pool did not build here")
    _, tm = plips
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = {m: tm.encode_images(jpegs, batch_size=4, decode_mode=m)
               for m in ("fast", "fast_approx", "exact")}
    for m in ("fast", "fast_approx"):
        np.testing.assert_allclose(out[m][[0, 2]], out["exact"][[0, 2]], rtol=1e-5, atol=1e-5)
    for a, b in (("fast", "fast_approx"), ("fast", "exact"), ("fast_approx", "exact")):
        assert not np.allclose(out[a][[1, 3]], out[b][[1, 3]], rtol=1e-5, atol=1e-5), (a, b)
