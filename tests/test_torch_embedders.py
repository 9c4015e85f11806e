"""The port's embedders and harness utilities against the JAX package's (CPU).

- ``utils.config``, ``utils.cacher`` and ``utils.results_handler`` are
  copies: the same environment, the same cache paths, entries and
  ``.meta.json`` sidecars written by one package read by the other, the
  same results CSV bytes.
- ``CLIPEmbedder`` over the port's ``PLIP`` against the JAX one on one tiny
  ``.npz``: L2-normalized embeddings at the fp32 bars (row cosine > 0.9999,
  allclose 5e-3), cache first, the ``fast_approx`` entry refused.
- ``EmbedderFactory``: the dispatch, ``args.device``, the card by default,
  and ``mudipath`` refused.
- ``train.clip_tuner``'s module helpers against the JAX package's.
"""

import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.embedders import CLIPEmbedder as JEmbedder
from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.train import clip_tuner as jtuner
from plip_tpu.utils import cacher as jcacher
from plip_tpu.utils import config as jconfig
from plip_tpu.utils.checkpoint import save_checkpoint
from plip_tpu.utils.results_handler import ResultsHandler as JResults
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.embedders import CLIPEmbedder, EmbedderFactory
from plip_tpu_torch.train import clip_tuner as ttuner
from plip_tpu_torch.utils import cacher, config
from plip_tpu_torch.utils.results_handler import ResultsHandler

LABELS = ["an H&E image of benign tissue", "an H&E image of malignant tumor", "stroma"]


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    cfg = CLIPConfig(
        vision=VisionConfig(width=64, layers=2, heads=4, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=2, heads=4, vocab_size=49408, context_length=77),
        embed_dim=16,
    )
    path = str(tmp_path_factory.mktemp("ck") / "small.npz")
    save_checkpoint(path, jclip.init_params(jax.random.PRNGKey(1), cfg), cfg)
    return path


@pytest.fixture(scope="module")
def models(small_ckpt):
    return JPLIP(small_ckpt), PLIP(small_ckpt, device="cpu")


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PC_CACHE_FOLDER", str(tmp_path / "cache"))
    os.makedirs(tmp_path / "cache", exist_ok=True)
    return tmp_path


@pytest.fixture(scope="module")
def image_paths(tmp_path_factory):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("tiles")
    paths = []
    for i in range(6):
        p = str(d / f"tile_{i}.png")
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    return paths


def _close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_config_copy(tmp_path, monkeypatch):
    env = tmp_path / "pc.env"
    env.write_text("# comment\nPC_CACHE_FOLDER='/c'\nPC_CLIP_ARCH=\"ViT-L/14\"\nbad line\n"
                   "PC_RESULTS_FOLDER = /r\n")
    for k in ("PC_CACHE_FOLDER", "PC_CLIP_ARCH", "PC_RESULTS_FOLDER", "PC_DEFAULT_BACKBONE",
              "PC_EVALUATION_DATA_ROOT_FOLDER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PC_RESULTS_FOLDER", "/kept")  # the environment wins
    config.load_dotenv_file(str(env))
    config.load_dotenv_file(str(tmp_path / "missing.env"))
    got = config.PCConfig.from_env()
    jconfig.load_dotenv_file(str(env))
    want = jconfig.PCConfig.from_env()
    assert got.__dict__ == want.__dict__
    assert (got.cache_folder, got.clip_arch, got.results_folder) == ("/c", "ViT-L/14", "/kept")
    config.PCConfig(cache_folder="/x", default_backbone="b.pt").export_env()
    assert os.environ["PC_CACHE_FOLDER"] == "/x" and os.environ["PC_DEFAULT_BACKBONE"] == "b.pt"


@pytest.mark.parametrize("name,path", [("plipimgKather_test.csv", "/abs/dir/tuned.pt"),
                                       ("clipimgKather_test.csv", "/abs/dir/tuned.pt"),
                                       ("plipimgPanNuke", ""), ("clipimgx.csv", "rel/b.npz")])
def test_cache_paths_are_the_jax_packages(cache_env, name, path):
    assert cacher.get_savepath(name, path) == jcacher.get_savepath(name, path)
    assert cacher.get_cache_name(name, path) == jcacher.get_cache_name(name, path)


def test_cache_entries_interchange(cache_env):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    cacher.cache_numpy_object_raw_filename(a, "plipimgds.csv", "/x/b.pt")
    np.testing.assert_array_equal(jcacher.cache_hit_or_miss_raw_filename("plipimgds.csv",
                                                                         "/x/b.pt"), a)
    jcacher.cache_numpy_object(a * 2, "pliptxtds.csv", "b.pt")
    np.testing.assert_array_equal(cacher.cache_hit_or_miss("pliptxtds.csv", "b.pt"), a * 2)
    assert cacher.cache_hit_or_miss("pliptxtother", "b.pt") is None
    assert cacher.cache_hit_or_miss_raw_filename("plipimgother", "b.pt") is None
    path = cacher.get_savepath("plipimgds.csv", "/x/b.pt")
    cacher.write_cache_meta(path, {"decode_mode": "exact"})
    assert jcacher.read_cache_meta(path) == {"decode_mode": "exact"}
    with open(path + ".meta.json", "w") as f:
        f.write("{corrupt")
    assert cacher.read_cache_meta(path) is None and jcacher.read_cache_meta(path) is None


def test_results_csv_is_the_jax_packages(tmp_path, monkeypatch):
    rows = [{"Accuracy": 0.5, "split": "train"}, {"Accuracy": 0.25, "split": "test"}]
    files = {}
    for tag, cls in (("port", ResultsHandler), ("jax", JResults)):
        monkeypatch.setenv("PC_RESULTS_FOLDER", str(tmp_path / tag))
        h = cls("kather", "zero_shot", {"seed": 1, "model": "plip"})
        h.add([dict(r) for r in rows])
        files[tag] = h.add([dict(r) for r in rows])  # the second call appends
    with open(files["port"], "rb") as a, open(files["jax"], "rb") as b:
        assert a.read() == b.read()
    assert os.path.basename(files["port"]) == "extended_results_zero_shot_kather.csv"


def test_clip_embedder_against_jax(models, cache_env, image_paths):
    jm, tm = models
    emb = CLIPEmbedder(tm, "plip", "backbone_v1.pt")
    out = emb.image_embedder(image_paths, batch_size=4)
    assert out.shape == (6, 16)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    want = JEmbedder(jm, "plip", "other.pt").image_embedder(image_paths, batch_size=4)
    _close(out, want)
    # the port's entry is the JAX embedder's hit, and the other way round
    np.testing.assert_array_equal(
        JEmbedder(jm, "plip", "backbone_v1.pt").image_embedder(image_paths), out)
    np.testing.assert_array_equal(CLIPEmbedder(tm, "plip", "other.pt").image_embedder(
        image_paths), want)
    txt = emb.text_embedder(LABELS, batch_size=2)
    _close(txt, JEmbedder(jm, "plip", "other.pt").text_embedder(LABELS, batch_size=2))
    np.testing.assert_array_equal(emb.text_embedder(LABELS), txt)
    np.testing.assert_array_equal(
        JEmbedder(jm, "plip", "backbone_v1.pt").text_embedder(LABELS), txt)
    # another additional_cache_name misses and computes the same
    np.testing.assert_allclose(emb.image_embedder(image_paths, additional_cache_name="x.csv"),
                               out, rtol=1e-5)


def test_fast_approx_entry_is_refused(models, cache_env, image_paths):
    _, tm = models
    emb = CLIPEmbedder(tm, "plip", "backbone_v1.pt")
    out = emb.image_embedder(image_paths, batch_size=4, decode_mode="fast_approx")
    save_path = cacher.get_savepath("plipimg", "backbone_v1.pt")
    assert jcacher.read_cache_meta(save_path) == {"decode_mode": "fast_approx"}
    np.testing.assert_array_equal(
        emb.image_embedder(image_paths, batch_size=4, decode_mode="fast_approx"), out)
    with pytest.warns(UserWarning, match="fast_approx"):
        out3 = emb.image_embedder(image_paths, batch_size=4, decode_mode="fast")
    np.testing.assert_allclose(out, out3, rtol=1e-4)
    assert cacher.read_cache_meta(save_path) == {"decode_mode": "fast"}
    np.testing.assert_array_equal(
        emb.image_embedder(image_paths, decode_mode="fast_approx"), out3)
    os.remove(save_path + ".meta.json")  # the reference writes none: a hit
    np.testing.assert_array_equal(emb.image_embedder(image_paths, decode_mode="exact"), out3)


def test_factory_dispatch(small_ckpt, cache_env, monkeypatch, tmp_path):
    monkeypatch.setenv("PC_CLIP_ARCH", "ViT-B/32")
    f = EmbedderFactory()
    e = f.factory(SimpleNamespace(model_name="plip", backbone=small_ckpt, device="cpu"))
    assert isinstance(e, CLIPEmbedder) and e.backbone == small_ckpt
    assert e.model.cfg.embed_dim == 16 and e.model.device == torch.device("cpu")
    # a torch state_dict backbone loads through load_any_checkpoint
    pt = e.model.save(str(tmp_path / "tuned.pt"), format="openai")
    e2 = f.factory(SimpleNamespace(model_name="plip", backbone=pt, device="cpu"))
    for k, v in e.model.model.state_dict().items():
        assert torch.equal(e2.model.model.state_dict()[k], v), k
    monkeypatch.setenv("PLIP_TPU_CHECKPOINT", small_ckpt)
    e3 = f.factory(SimpleNamespace(model_name="clip", backbone="", device="cpu"))
    assert e3.model.cfg.embed_dim == 16 and e3.name == "clip"
    with pytest.raises(NotImplementedError, match="item 8"):
        f.factory(SimpleNamespace(model_name="mudipath", backbone=""))
    with pytest.raises(ValueError):
        f.factory(SimpleNamespace(model_name="nope", backbone=""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):  # the card unless told
        f.factory(SimpleNamespace(model_name="plip", backbone=small_ckpt))


def test_tuner_helpers_against_jax(models, image_paths):
    jm, tm = models
    _close(ttuner.image_embedder(tm, image_paths, batch_size=4),
           jtuner.image_embedder(jm, image_paths, batch_size=4))
    _close(ttuner.text_embedder(tm, LABELS), jtuner.text_embedder(jm, LABELS))
    got = ttuner.zero_shot_classification(tm, image_paths, LABELS)
    assert got == jtuner.zero_shot_classification(jm, image_paths, LABELS)
    assert len(got) == 6 and set(got) <= set(LABELS)
