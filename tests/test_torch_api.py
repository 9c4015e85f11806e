"""The port's public ``PLIP`` against ``plip_tpu.api.PLIP`` (CPU).

Both load one tiny ``.npz`` saved by the JAX package and answer the same
requests on uint8 arrays made with numpy from a seed. fp32 bars: row cosine
> 0.9999 and allclose 5e-3; identical labels and retrieval indices."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from plip_tpu.api import PLIP as JPLIP
from plip_tpu.models import clip as jclip
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig
from plip_tpu.ops.preprocess import preprocess_images as jax_preprocess
from plip_tpu.utils.checkpoint import load_checkpoint as jax_load
from plip_tpu.utils.checkpoint import save_checkpoint as jax_save
from plip_tpu_torch.api import PLIP
from plip_tpu_torch.ops.preprocess import preprocess_images


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["an H&E image of benign tissue", "an H&E image of malignant tumor",
          "an H&E image of normal mucosa", "an H&E image of stroma"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    # 224-px images so the whole preprocessing path runs; the real vocab size
    # so the default tokenizer's ids fit
    cfg = CLIPConfig(
        vision=VisionConfig(width=64, layers=2, heads=4, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=2, heads=4, vocab_size=49408, context_length=77),
        embed_dim=24,
    )
    params = jclip.init_params(jax.random.PRNGKey(7), cfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jax_save(path, params, cfg)
    return path


@pytest.fixture(scope="module")
def models(tiny_ckpt):
    return JPLIP(tiny_ckpt), PLIP(tiny_ckpt, device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    ims = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(5)]
    ims.append(rng.integers(0, 256, (300, 240, 3), dtype=np.uint8))  # a second size
    return ims


def _assert_close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999, cos.min()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_preprocess_matches_jax(images):
    """Same matrices, same uint8 rounding: at most one uint8 level apart
    where a sum lands on a rounding boundary, and that only rarely."""
    ims = images + [images[0][:224, :224, 0]]  # and a grey 224x224 image
    want = np.asarray(jax_preprocess(ims))
    got = preprocess_images(ims).numpy()
    assert got.shape == want.shape == (len(ims), 224, 224, 3)
    diff = np.abs(got - want)
    one_level = 1.0 / (255 * 0.26130258)  # smallest CLIP std
    assert diff.max() <= one_level * 1.001
    assert (diff > 1e-5).mean() < 1e-3


def test_encode_images(models, images):
    jm, tm = models
    want = jm.encode_images(images, batch_size=4)
    got = tm.encode_images(images, batch_size=4)
    assert got.shape == (6, 24) and got.dtype == np.float32
    _assert_close(got, want)
    assert not np.allclose(np.linalg.norm(got, axis=-1), 1.0)  # unnormalized


def test_encode_text(models):
    jm, tm = models
    texts = LABELS + ["a much longer caption " * 30]  # truncated at 77 tokens
    _assert_close(tm.encode_text(texts, batch_size=3), jm.encode_text(texts, batch_size=3))


def test_empty_inputs(models):
    _, tm = models
    assert tm.encode_images([]).shape == (0, 24)
    assert tm.encode_text([]).shape == (0, 24)


def test_zero_shot_classification(models, images):
    jm, tm = models
    assert tm.zero_shot_classification(images, LABELS) == \
        jm.zero_shot_classification(images, LABELS)


def test_retrieval(models, images):
    jm, tm = models
    with pytest.raises(RuntimeError, match="image index"):
        PLIP(tm.model_name, device="cpu").retrieval(["benign tissue"])
    want = jm.build_image_index(images, batch_size=4)
    got = tm.build_image_index(images, batch_size=4)
    _assert_close(got, want)
    queries = ["an image of tumor", "benign tissue"]
    idx = tm.retrieval(queries, top_k=3)
    assert idx.shape == (2, 3)
    np.testing.assert_array_equal(idx, jm.retrieval(queries, top_k=3, backend="host"))
    np.testing.assert_array_equal(tm.retrieval(queries, top_k=3, backend="host"), idx)
    np.testing.assert_array_equal(tm.retrieval(queries, top_k=3, backend="device"), idx)
    with pytest.raises(ValueError, match="unknown retrieval backend"):
        tm.retrieval(queries, backend="gpu")


def test_set_image_index(models):
    _, tm = models
    vecs = np.random.default_rng(1).standard_normal((5, 24)).astype(np.float32)
    assert tm.set_image_index(vecs) is vecs and tm.image_vectors is vecs
    assert tm.retrieval(["benign tissue"], top_k=5).shape == (1, 5)


def test_npz_roundtrip_into_jax(models, tiny_ckpt, tmp_path):
    """An npz the port saves loads in the JAX package with the same leaves."""
    jm, tm = models
    path = tm.save(str(tmp_path / "port.npz"))
    got, cfg = jax_load(path)
    want, want_cfg = jax_load(tiny_ckpt)
    assert cfg == want_cfg
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    pt = tm.save(str(tmp_path / "port.pt"), format="openai")
    back = PLIP(pt, device="cpu")  # a state_dict carries no head count: width // 64
    assert back.cfg == dataclasses.replace(
        tm.cfg, vision=dataclasses.replace(tm.cfg.vision, heads=1),
        text=dataclasses.replace(tm.cfg.text, heads=1))
    for k, v in tm.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v), k


def test_random_spec_is_seeded():
    a = PLIP("random:ViT-B/32", device="cpu")
    b = PLIP("random:ViT-B/32", device="cpu")
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.cfg.vision.width == 768 and len(a.model.visual.blocks) == 12


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import plip_tpu_torch\n"
        "for m in pkgutil.walk_packages(plip_tpu_torch.__path__, 'plip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "plip_tpu_torch.PLIP, plip_tpu_torch.CLIPConfig\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": ROOT},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """No CUDA device here: the smoke script exits non-zero and prints no
    result, both from the repo and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    for cwd in (ROOT, str(tmp_path)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
