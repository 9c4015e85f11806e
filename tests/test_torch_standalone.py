"""The port stands alone (CPU).

- Importing every module of ``plip_tpu_torch``, and ``chip_smoke.py``, loads
  no module of ``plip_tpu`` and none of JAX (checked in a fresh interpreter).
- The modules the port copied from the JAX package's framework-free code
  give what the originals give: token ids on a corpus (the same vocabulary
  resolution), resize matrices at several sizes, ``load_image_rgb`` on
  arrays, PIL images and files.
- Its entry points run on the card unless the caller asks for the CPU:
  ``PLIP(...)`` and ``CLIPTuner(...)`` with no ``device`` raise where there
  is no CUDA device.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import plip_tpu_torch
from plip_tpu import tokenizer as jtok
from plip_tpu.data import datasets as jdata
from plip_tpu.ops import resize as jresize
from plip_tpu_torch import tokenizer as ttok
from plip_tpu_torch.data import datasets as tdata
from plip_tpu_torch.ops import resize as tresize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(plip_tpu_torch.__path__,
                                                        "plip_tpu_torch."))


def test_port_imports_no_jax_and_no_jax_package():
    mods = _port_modules()
    assert {"plip_tpu_torch.tokenizer.bpe", "plip_tpu_torch.native",
            "plip_tpu_torch.data.datasets", "plip_tpu_torch.ops.resize",
            "plip_tpu_torch.train.clip_tuner", "plip_tpu_torch.api",
            "plip_tpu_torch.ops.block_bwd", "plip_tpu_torch.ops.mlp",
            "plip_tpu_torch.ops.block", "plip_tpu_torch.ops.preprocess_fused"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'plip_tpu'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


CORPUS = [
    "an H&E image of benign tissue",
    "An H&E image of MALIGNANT tumor, case #12 — 40x",
    "schÃ¶n “quotes” and ｆｕｌｌｗｉｄｔｈ text &amp; entities",
    "",
    "lymphocytes " * 40,
    "colorectal adenocarcinoma epithelium, mucosa; stroma!",
]


def test_tokenizer_copy_gives_the_same_ids(monkeypatch):
    monkeypatch.delenv("PLIP_TPU_VOCAB", raising=False)
    want = jtok.default_tokenizer().tokenize(CORPUS, 77)
    got = ttok.default_tokenizer().tokenize(CORPUS, 77)
    assert got.dtype == want.dtype and got.shape == (len(CORPUS), 77)
    np.testing.assert_array_equal(got, want)


def test_tokenizer_copy_reads_the_same_override(monkeypatch, tmp_path):
    """``PLIP_TPU_VOCAB`` points both packages at the same vocabulary."""
    merges = jtok.train_bpe(" ".join(CORPUS[:2] + CORPUS[5:]) * 3, 40)
    path = str(tmp_path / "vocab.txt.gz")
    jtok.save_openai_format(jtok.CLIPBPETokenizer(jtok.vocab_from_merges(merges), merges),
                            path)
    monkeypatch.setenv("PLIP_TPU_VOCAB", path)
    want = jtok.default_tokenizer()
    got = ttok.default_tokenizer()
    assert got.encoder == want.encoder and len(got.encoder) == 512 + len(merges) + 2
    np.testing.assert_array_equal(got.tokenize(CORPUS, 77), want.tokenize(CORPUS, 77))


@pytest.mark.parametrize("h,w,shortest,crop", [(256, 256, 224, 224), (300, 500, 224, 224),
                                               (512, 384, 336, 336), (240, 1000, 224, 200)])
def test_resize_copy_gives_the_same_matrices(h, w, shortest, crop):
    for got, want in zip(tresize.resize_crop_matrices(h, w, shortest, crop),
                         jresize.resize_crop_matrices(h, w, shortest, crop)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tresize.torchvision_resized_dims(h, w, shortest) == \
        jresize.torchvision_resized_dims(h, w, shortest)


def test_load_image_rgb_copy(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (40, 30, 3), np.uint8)
    gray = rng.integers(0, 256, (20, 25), np.uint8)
    png, jpg = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    Image.fromarray(rgb).save(png)
    Image.fromarray(rgb).save(jpg, quality=90)
    for item in (rgb, gray, Image.fromarray(gray), Image.fromarray(rgb).convert("RGBA"),
                 png, jpg):
        got, want = tdata.load_image_rgb(item), jdata.load_image_rgb(item)
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, want)
    ds = tdata.ImageCaptionDataset({"image": [rgb, png], "caption": ["x", "y"]},
                                   lambda img, index: img[index:])
    assert len(ds) == 2 and ds[1][1] == "y"
    np.testing.assert_array_equal(ds[1][0], rgb[1:])


def test_entry_points_need_the_card_unless_told_otherwise(monkeypatch):
    """Without a CUDA device ``PLIP`` and ``CLIPTuner`` raise and name
    ``device="cpu"``; with it they run on the CPU."""
    from plip_tpu_torch.api import PLIP
    from plip_tpu_torch.train.clip_tuner import CLIPTuner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PLIP("random:ViT-B/32")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CLIPTuner()
    assert PLIP("random:ViT-B/32", device="cpu").device == torch.device("cpu")
