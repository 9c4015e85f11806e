"""The port stands alone (CPU).

- Importing every module of ``plip_tpu_torch``, and ``chip_smoke.py``, loads
  no module of ``plip_tpu``, none of JAX, and neither scikit-learn nor
  pandas (checked in a fresh interpreter).
- The modules the port copied from the JAX package's framework-free code
  give what the originals give: token ids on a corpus (the same vocabulary
  resolution), resize matrices at several sizes, ``load_image_rgb`` on
  arrays, PIL images and files.
- Its entry points run on the card unless the caller asks for the CPU:
  ``PLIP(...)``, ``CLIPTuner(...)``, ``FineTuner(...)``, ``build_resnet``
  and ``build_densenet`` with no ``device`` raise where there is no CUDA
  device.
- The copies of ``ImageDataset`` (``on_error``), ``ImageLabelDataset`` and
  ``CaptionDataset`` give the originals' items; the loader's ``collate=``
  keeps a batch of images of many sizes as a list; the reference's four
  dataset names are the port's classes and give the JAX classes' items.
- Every public module-level class and function of ``plip_tpu`` has a
  counterpart in the port's module of the same path, or is on
  ``NOT_PORTED`` with its reason (an ``ast`` walk of both source trees).
"""

import ast
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op torch thread: under the suite's parallel workers the
    default threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
            "plip_tpu_torch.ops.block", "plip_tpu_torch.ops.preprocess_fused",
            "plip_tpu_torch.ops.retrieval", "plip_tpu_torch.scripts.import_checkpoint",
            "plip_tpu_torch.scripts.export_checkpoint", "plip_tpu_torch.ops.quant",
            "plip_tpu_torch.utils.config", "plip_tpu_torch.utils.cacher",
            "plip_tpu_torch.utils.results_handler", "plip_tpu_torch.eval.metrics",
            "plip_tpu_torch.eval.zero_shot", "plip_tpu_torch.eval.retrieval",
            "plip_tpu_torch.eval.linear_probe", "plip_tpu_torch.embedders.abst",
            "plip_tpu_torch.embedders.clip_embedder", "plip_tpu_torch.embedders.factory",
            "plip_tpu_torch.scripts.zero_shot_evaluation",
            "plip_tpu_torch.scripts.linear_probing_evaluation",
            "plip_tpu_torch.scripts.retrieval_evaluation",
            "plip_tpu_torch.scripts.extract_embedding", "plip_tpu_torch.data.wsi",
            "plip_tpu_torch.datagen.preprocess_digestpath", "plip_tpu_torch.models.vit",
            "plip_tpu_torch.models.resnet", "plip_tpu_torch.models.densenet",
            "plip_tpu_torch.train.finetune", "plip_tpu_torch.eval.fine_tuning",
            "plip_tpu_torch.embedders.mudipath",
            "plip_tpu_torch.scripts.fine_tuning_train",
            "plip_tpu_torch.scripts.fine_tuning_analysis",
            "plip_tpu_torch.datagen.dataset_loader",
            "plip_tpu_torch.datagen.prepare_dataset_to_csv",
            "plip_tpu_torch.datagen.preprocess_pannuke", "plip_tpu_torch.utils.profiling",
            "plip_tpu_torch.parallel.distributed", "plip_tpu_torch.parallel.mesh",
            "plip_tpu_torch.ops.tp"} <= set(mods)
    # nor, at import, scikit-learn or pandas, which the machine with the card lacks
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'plip_tpu', 'sklearn', 'pandas'))\n"
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

    from types import SimpleNamespace

    from plip_tpu_torch.embedders.mudipath import build_densenet, build_resnet
    from plip_tpu_torch.train.finetune import FineTuner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PLIP("random:ViT-B/32")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CLIPTuner()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FineTuner(args=SimpleNamespace(model_name="resnet18", optimizer="SGD"), num_classes=2)
    for build in (build_resnet, build_densenet):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build(arch="resnet18" if build is build_resnet else "densenet121")
    assert PLIP("random:ViT-B/32", device="cpu").device == torch.device("cpu")
    model, arch = build_resnet(arch="resnet18", device="cpu")
    assert arch == "resnet18" and not model.training and model.fc is None


def test_image_dataset_copies(tmp_path):
    from plip_tpu_torch.data.loader import PrefetchLoader

    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in ((30, 40), (22, 22))]
    png = str(tmp_path / "a.png")
    Image.fromarray(imgs[0]).save(png)
    items = [imgs[1], png, str(tmp_path / "missing.png")]
    for on_error in ("raise", "zero"):
        got = tdata.ImageDataset(items, on_error=on_error, zero_shape=(8, 8, 3))
        want = jdata.ImageDataset(items, on_error=on_error, zero_shape=(8, 8, 3))
        assert len(got) == len(want) == 3
        for i in range(2):
            np.testing.assert_array_equal(got[i], want[i])
        if on_error == "raise":
            with pytest.raises(Exception):
                got[2]
        else:
            np.testing.assert_array_equal(got[2], want[2])
            assert got.failed_indices == want.failed_indices == [2]
    df = {"image": [png, imgs[1]], "label": [3, 1]}
    got, want = tdata.ImageLabelDataset(df, lambda im: im[:5]), jdata.ImageLabelDataset(
        df, lambda im: im[:5])
    for i in range(2):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    batches = list(PrefetchLoader(tdata.ImageDataset(items[:2]), 2, num_workers=2,
                                  collate=lambda items, bs: list(items)))
    assert len(batches) == 1 and batches[0][1] == 2 and isinstance(batches[0][0], list)
    assert [b.shape for b in batches[0][0]] == [(22, 22, 3), (30, 40, 3)]


def test_caption_dataset_copy():
    captions = ("a", "H&E of benign tissue", "", "x" * 300)
    got, want = tdata.CaptionDataset(captions), jdata.CaptionDataset(captions)
    assert len(got) == len(want) == 4
    assert [got[i] for i in range(4)] == [want[i] for i in range(4)] == list(captions)
    assert got[-1] == want[-1]
    with pytest.raises(IndexError):
        got[4]


REFERENCE_NAMES = {"CLIPImageCaptioningDataset": "ImageCaptionDataset",
                   "CLIPCaptioningDataset": "CaptionDataset",
                   "CLIPImageDataset": "ImageDataset",
                   "CLIPImageLabelDataset": "ImageLabelDataset"}


@pytest.mark.parametrize("name", list(REFERENCE_NAMES))
def test_reference_dataset_names(tmp_path, name):
    """``embedders/internal_datasets.py`` of the reference imports these
    four names: each is the port's class of its counterpart, and gives the
    items of the JAX package's class of the same name."""
    assert getattr(tdata, name) is getattr(tdata, REFERENCE_NAMES[name])
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (12, 9, 3), np.uint8)
    png = str(tmp_path / "a.png")
    Image.fromarray(img).save(png)
    images, text = [img, png], ["first caption", "second"]
    args = {"CLIPImageCaptioningDataset": ({"image": images, "caption": text},),
            "CLIPCaptioningDataset": (text,),
            "CLIPImageDataset": (images,),
            "CLIPImageLabelDataset": ({"image": images, "label": [4, 0]},)}[name]
    got, want = getattr(tdata, name)(*args), getattr(jdata, name)(*args)
    assert len(got) == len(want) == 2
    for i in range(2):
        g, w = got[i], want[i]
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1]
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


# Public module-level names of ``plip_tpu`` that the port's module of the same
# path does not bind: ``(counterpart, reason)``. A counterpart
# ``"module.py:Name"`` or ``"module.py:Class.method"`` (a path under
# ``plip_tpu_torch/``) is checked to exist; None means there is none by design.
_MODULE = "the JAX package's functional init/forward over a params tree; the port's nn.Module"
_SHARDING = "jax.sharding specs; the port shards on torch.distributed"
NOT_PORTED = {
    ("models/clip.py", "init_params"): ("models/clip.py:CLIP.init_params", _MODULE),
    ("models/clip.py", "encode_image"): ("models/clip.py:CLIP.encode_image", _MODULE),
    ("models/clip.py", "encode_text"): ("models/clip.py:CLIP.encode_text", _MODULE),
    ("models/clip.py", "forward"): ("models/clip.py:CLIP.forward", _MODULE),
    ("models/clip.py", "causal_mask"):
        (None, "the cores take causal=True and build no [S, S] mask tensor"),
    ("models/clip.py", "num_params"):
        (None, "a params-tree helper; sum(p.numel() for p in model.parameters())"),
    ("models/densenet.py", "init_params"): ("models/densenet.py:DenseNet.init_params", _MODULE),
    ("models/densenet.py", "forward_features"):
        ("models/densenet.py:DenseNet.forward_features", _MODULE),
    ("models/resnet.py", "init_params"): ("models/resnet.py:ResNet.init_params", _MODULE),
    ("models/resnet.py", "forward"): ("models/resnet.py:ResNet.forward", _MODULE),
    ("models/resnet.py", "forward_features"):
        ("models/resnet.py:ResNet.forward_features", _MODULE),
    ("models/resnet.py", "batch_norm"):
        (None, "torch.nn.BatchNorm2d, whose buffers update in place in train mode"),
    ("models/resnet.py", "merge_bn_stats"):
        (None, "folds returned BN statistics into a params tree; nn.BatchNorm2d's buffers "
               "update in place"),
    ("models/vit.py", "init_params"): ("models/vit.py:ViTClassifier.init_params", _MODULE),
    ("models/vit.py", "forward"): ("models/vit.py:ViTClassifier.forward", _MODULE),
    ("models/layers.py", "init_block_stack"):
        ("models/layers.py:Transformer.init_params", _MODULE),
    ("models/layers.py", "transformer"): ("models/layers.py:Transformer.forward", _MODULE),
    ("models/layers.py", "block"): ("models/layers.py:Block.forward", _MODULE),
    ("models/layers.py", "attention"): ("models/layers.py:Block.composed_attention", _MODULE),
    ("models/layers.py", "linear"): ("ops/attention.py:linear", _MODULE),
    ("models/layers.py", "mlp"): ("ops/mlp.py:mlp", _MODULE),
    ("models/layers.py", "quick_gelu"): ("ops/mlp.py:quick_gelu", _MODULE),
    ("ops/attention.py", "fused_attention"):
        ("ops/mha.py:mha_core", "the TPU kernels behind it are ported as ops/mha.py's cores"),
    ("ops/attention.py", "attention_sublayer_flat"):
        (None, "flat [B*S, W] tokens with a block-diagonal core fit Mosaic and the MXU; "
               "the port's K1 takes [B, S, W] (ROADMAP, 'what the port need not copy')"),
    ("ops/preprocess_pallas.py", "preprocess_batch_pallas"):
        ("ops/preprocess_fused.py:preprocess_batch_fused", "K11's port has its own module"),
    ("parallel/mesh.py", "batch_sharding"): ("parallel/mesh.py:shard_batch", _SHARDING),
    ("parallel/mesh.py", "param_shardings"): ("parallel/mesh.py:shard_params", _SHARDING),
    ("parallel/mesh.py", "param_specs"): ("parallel/mesh.py:param_spec", _SHARDING),
    ("train/contrastive.py", "clamp_logit_scale"):
        ("train/contrastive.py:clamp_logit_scale_", "clamps the module's parameter in place"),
    ("train/contrastive.py", "fused_adamw"):
        ("train/contrastive.py:FusedAdamW", "an optax transformation; the port's optimizer class"),
    ("train/contrastive.py", "save_train_state_orbax"):
        ("train/contrastive.py:save_train_state_sharded", "orbax is JAX's; "
         "torch.distributed.checkpoint takes its place"),
    ("train/contrastive.py", "load_train_state_orbax"):
        ("train/contrastive.py:load_train_state_sharded", "orbax is JAX's; "
         "torch.distributed.checkpoint takes its place"),
    ("utils/profiling.py", "ThroughputMeter"):
        (None, "no code of the port read its rolling rate; the program's spans "
               "(utils/profiling.py span_totals) count and time the host's work"),
    ("utils/profiling.py", "MetricLogger"):
        (None, "no code of the port wrote through this JSONL sink"),
}
for _name in ("enable_compile_cache", "disable_compile_cache", "enable_from_env"):
    NOT_PORTED["utils/compile_cache.py", _name] = (
        None, "XLA's persistent compilation cache; the port's kernels are built by nvcc "
              "once into plip_tpu_torch/_build (ROADMAP Queue 1 item 10)")


def _tree(package, rel):
    path = os.path.join(ROOT, package, rel)
    return ast.parse(open(path).read()) if os.path.exists(path) else None


def _bound(tree):
    """The names a module binds at its top level."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _defines(tree, qualname):
    body = tree.body
    for part in qualname.split("."):
        node = next((n for n in body if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and n.name == part), None)
        if node is None:
            return False
        body = node.body
    return True


def test_every_public_name_of_the_jax_package_is_ported():
    """An ``ast`` walk over both source trees (nothing is imported): every
    public module-level class and function of ``plip_tpu`` is bound by the
    port's module of the same path, or is on ``NOT_PORTED``, whose named
    counterparts exist and whose entries are all still needed."""
    missing, used = [], set()
    jax_root = os.path.join(ROOT, "plip_tpu")
    for folder, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(folder, f), jax_root).replace(os.sep, "/")
            names = {n.name for n in _tree("plip_tpu", rel).body
                     if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                     and not n.name.startswith("_")}
            port = _tree("plip_tpu_torch", rel)
            for name in sorted(names - (_bound(port) if port else set())):
                if (rel, name) in NOT_PORTED:
                    used.add((rel, name))
                else:
                    missing.append(f"{rel}:{name}")
    assert not missing, f"public names of plip_tpu with no counterpart in the port: {missing}"
    assert used == set(NOT_PORTED), sorted(set(NOT_PORTED) - used)
    for (rel, name), (counterpart, reason) in NOT_PORTED.items():
        assert reason
        if counterpart is not None:
            path, qualname = counterpart.split(":")
            tree = _tree("plip_tpu_torch", path)
            assert tree is not None and _defines(tree, qualname), (rel, name, counterpart)
