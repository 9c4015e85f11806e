"""The port's evaluation and fine-tuning CLIs against the JAX package's (CPU).

``tests/test_scripts.py``'s synthetic mini-dataset (12 PNG tiles in two
classes, a train/test split and a retrieval TSV) and its tiny ``.npz``
backbone, written once. Each CLI runs in both packages with its own cache
and results folders (so neither reads the other's embeddings), the port's
with ``--device cpu``; their CSVs and ``.npy`` files are compared: metrics
equal (numbers to 1e-12), embeddings at the fp32 bars (row cosine > 0.9999,
allclose 5e-3). ``extract_embedding``'s OpenPath branch draws its crops
from a ``torch.Generator``, not JAX's stream, so it is held by shape,
finiteness and reproducibility under a fixed seed. The cache is reused on
a second run, and no CLI module imports pandas before ``main`` runs.
``fine_tuning_train`` runs the learning-rate search and the retrain of
``tests/test_scripts.py`` on PanNuke-style labels in both packages with the
same heads (the JAX tuner's head copied into the port's ``FineTuner``): the
``performance_*.tsv`` tables agree (losses rtol 1e-4, F1s to 1e-6), and the
skip-if-done guard holds; ``fine_tuning_analysis`` harvests one synthetic
results tree to the same tables and ``perf_mean.csv``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

pd = pytest.importorskip("pandas")

from plip_tpu.models import clip as jclip  # noqa: E402
from plip_tpu.models.config import CLIPConfig, TextConfig, VisionConfig  # noqa: E402
from plip_tpu.scripts import extract_embedding as jextract  # noqa: E402
from plip_tpu.scripts import fine_tuning_analysis as janalysis  # noqa: E402
from plip_tpu.scripts import fine_tuning_train as jfinetune  # noqa: E402
from plip_tpu.train import finetune as jft  # noqa: E402
from plip_tpu.scripts import linear_probing_evaluation as jlinear  # noqa: E402
from plip_tpu.scripts import retrieval_evaluation as jretrieval  # noqa: E402
from plip_tpu.scripts import zero_shot_evaluation as jzero  # noqa: E402
from plip_tpu.utils.checkpoint import save_checkpoint  # noqa: E402
from plip_tpu_torch.scripts import extract_embedding as textract  # noqa: E402
from plip_tpu_torch.scripts import fine_tuning_analysis as tanalysis  # noqa: E402
from plip_tpu_torch.scripts import fine_tuning_train as tfinetune  # noqa: E402
from plip_tpu_torch.train import finetune as tft  # noqa: E402
from plip_tpu_torch.scripts import linear_probing_evaluation as tlinear  # noqa: E402
from plip_tpu_torch.scripts import retrieval_evaluation as tretrieval  # noqa: E402
from plip_tpu_torch.scripts import zero_shot_evaluation as tzero  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("repro")
    (root / "data").mkdir()
    cfg = CLIPConfig(
        vision=VisionConfig(width=32, layers=2, heads=2, image_size=224, patch_size=32),
        text=TextConfig(width=32, layers=2, heads=2, vocab_size=49408, context_length=77),
        embed_dim=16,
    )
    ckpt = str(root / "plip_tiny.npz")
    save_checkpoint(ckpt, jclip.init_params(jax.random.PRNGKey(5), cfg), cfg)

    from PIL import Image

    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        label = ["benign", "malignant"][i % 2]
        p = str(root / "data" / f"tile_{i}.png")
        Image.fromarray(rng.integers(0, 256, (224, 224, 3), dtype=np.uint8)).save(p)
        rows.append({"image": p, "label": label,
                     "text_style_4": f"An H&E image patch of {label}."})
    df = pd.DataFrame(rows)
    df.iloc[:8].to_csv(root / "data" / "minikather_train.csv", index=False)
    df.iloc[8:].to_csv(root / "data" / "minikather_test.csv", index=False)
    pd.DataFrame({"images": df["image"], "captions": df["text_style_4"]}).to_csv(
        root / "data" / "minikather_retrieval.tsv", sep="\t", index=False)
    df.iloc[8:].to_csv(root / "data" / "Kather_mini.csv")
    # OpenPath: tiles of other sizes, under hashtag folders
    (root / "data" / "tw").mkdir()
    op = []
    for i, (h, w) in enumerate([(300, 260), (256, 256), (520, 700), (240, 400), (600, 600)]):
        p = str(root / "data" / "tw" / f"{100 + i}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
        op.append({"image": p, "caption": f"tweet {i} #pathology", "weblink": f"w{i}",
                   "id": i})
    pd.DataFrame(op).to_csv(root / "data" / "T-noQ.csv", index=False)
    return root, ckpt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The probes run 2,000 steps of small ops: one intra-op thread, so that
    the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _use(monkeypatch, env, tag):
    """Point the PC_* variables at ``tag``'s own cache and results folders."""
    root, ckpt = env
    for k, v in {"PC_CACHE_FOLDER": root / tag / "cache",
                 "PC_RESULTS_FOLDER": root / tag / "results",
                 "PC_EVALUATION_DATA_ROOT_FOLDER": root / "data",
                 "PC_CLIP_ARCH": "ViT-B/32", "PC_DEFAULT_BACKBONE": ckpt,
                 "PC_DOTENV": root / "nonexistent.env"}.items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.delenv("PLIP_TPU_CHECKPOINT", raising=False)
    return root / tag


def _run_both(monkeypatch, env, jmain, tmain, argv, jargv=None):
    jdir = _use(monkeypatch, env, "jax")
    want = jmain(jargv or argv)
    tdir = _use(monkeypatch, env, "port")
    got = tmain(argv + ["--device", "cpu"])
    return (jdir, want), (tdir, got)


def _same_metrics(got, want):
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], str):
                assert g[k] == w[k], k
            elif np.isnan(w[k]):
                assert np.isnan(g[k]), k
            else:
                assert abs(g[k] - w[k]) <= 1e-12, (k, g[k], w[k])


def _same_csv(a, b):
    da, db = pd.read_csv(a, index_col=0), pd.read_csv(b, index_col=0)
    assert list(da.columns) == list(db.columns) and da.shape == db.shape
    pd.testing.assert_frame_equal(da, db, check_exact=False, rtol=1e-12, atol=1e-12)


def _close(got, want):
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.9999
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def test_zero_shot_cli(env, monkeypatch):
    (jdir, want), (tdir, got) = _run_both(monkeypatch, env, jzero.main, tzero.main,
                                          ["--dataset", "minikather"])
    _same_metrics(got, want)
    name = "extended_results_zero_shot_minikather.csv"
    _same_csv(tdir / "results" / name, jdir / "results" / name)
    cache = [tdir / "cache" / "minikather_test" / "plip", jdir / "cache" / "minikather_test" /
             "plip"]
    _close(np.load(cache[0] / "plip_tiny.npz"), np.load(cache[1] / "plip_tiny.npz"))
    # a second run hits the port's cache: nothing in it is written again
    before = {f: os.path.getmtime(cache[0] / f) for f in os.listdir(cache[0])}
    _use(monkeypatch, env, "port")
    _same_metrics(tzero.main(["--dataset", "minikather", "--device", "cpu"]), got)
    assert {f: os.path.getmtime(cache[0] / f) for f in os.listdir(cache[0])} == before


@pytest.mark.parametrize("backend", ["sklearn", "torch"])
def test_linear_probing_cli(env, monkeypatch, backend, one_thread):
    argv = ["--dataset", "minikather", "--alpha", "0.01", "--probe_backend", backend]
    jargv = argv[:-1] + ["jax" if backend == "torch" else backend]
    (jdir, want), (tdir, got) = _run_both(monkeypatch, env, jlinear.main, tlinear.main, argv,
                                          jargv)
    _same_metrics(got, want)
    per_run = os.path.join("results", "minikather", "plip", "seed=1", "alpha=0.01",
                           "plip_tiny.npz.csv")
    _same_csv(tdir / per_run, jdir / per_run)
    assert len(pd.read_csv(tdir / per_run, index_col=0)) == 2  # train and test rows
    name = "extended_results_linear_probing_minikather.csv"
    assert (tdir / "results" / name).exists()
    for split in ("minikather_train", "minikather_test"):
        _close(np.load(tdir / "cache" / split / "plip" / "plip_tiny.npz"),
               np.load(jdir / "cache" / split / "plip" / "plip_tiny.npz"))


def test_retrieval_cli(env, monkeypatch):
    (jdir, want), (tdir, got) = _run_both(monkeypatch, env, jretrieval.main, tretrieval.main,
                                          ["--dataset", "minikather"])
    _same_metrics(got, want)
    name = "extended_results_retrieval_minikather.csv"
    _same_csv(tdir / "results" / name, jdir / "results" / name)


def test_extract_embedding_cli(env, monkeypatch):
    argv = ["--dataset", "Kather_mini", "--batch-size", "4"]
    (_, jpath), (_, tpath) = _run_both(monkeypatch, env, jextract.main, textract.main, argv)
    for suffix in ("_image_embeddings", "_text_embeddings", "_image_embeddings_normalized",
                   "_embeddings_normalized"):
        got = np.load(os.path.join(tpath, "Kather_mini" + suffix + ".npy"))
        _close(got, np.load(os.path.join(jpath, "Kather_mini" + suffix + ".npy")))
    norm = np.load(os.path.join(tpath, "Kather_mini_image_embeddings_normalized.npy"))
    np.testing.assert_allclose(np.linalg.norm(norm, axis=1), 1.0, rtol=1e-5)
    _same_csv(os.path.join(tpath, "Kather_mini.csv"), os.path.join(jpath, "Kather_mini.csv"))
    with open(os.path.join(tpath, "..", "README.md")) as a, \
            open(os.path.join(jpath, "..", "README.md")) as b:
        assert a.read() == b.read()


def test_extract_embedding_openpath(env, monkeypatch):
    argv = ["--dataset", "OpenPath", "--batch-size", "2", "--first_resize", "256",
            "--random_seed", "3", "--device", "cpu"]
    runs = []
    for tag in ("port", "port again"):
        _use(monkeypatch, env, tag)
        path = textract.main(argv)
        runs.append({s: np.load(os.path.join(path, f"OpenPath{s}.npy"))
                     for s in ("_image_embeddings", "_text_embeddings")})
    img = runs[0]["_image_embeddings"]
    assert img.shape == (5, 16) and runs[0]["_text_embeddings"].shape == (5, 16)
    assert np.isfinite(img).all() and len({tuple(r) for r in img.round(6)}) == 5
    for s in runs[0]:
        np.testing.assert_array_equal(runs[1][s], runs[0][s])  # the same seed, the same crops
    manifest = pd.read_csv(os.path.join(path, "df_5.csv"), index_col=0)
    assert list(manifest.columns) == ["source", "hashtag", "weblink", "id", "media ID",
                                      "caption"]
    assert (manifest["hashtag"] == "tw").all()
    _use(monkeypatch, env, "port other seed")
    other = np.load(os.path.join(textract.main(argv[:-3] + ["4", "--device", "cpu"]),
                                 "OpenPath_image_embeddings.npy"))
    assert not np.array_equal(other, img)


def test_cli_modules_import_no_pandas():
    mods = ["plip_tpu_torch.scripts." + m for m in (
        "zero_shot_evaluation", "linear_probing_evaluation", "retrieval_evaluation",
        "extract_embedding", "fine_tuning_train", "fine_tuning_analysis")]
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pandas', 'sklearn', 'jax', 'plip_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def _pannuke(root):
    """``tests/test_scripts.py``'s PanNuke-style copy of the mini-dataset
    (integer labels)."""
    for split in ("train", "test"):
        d = pd.read_csv(root / "data" / f"minikather_{split}.csv")
        d["label"] = (d["label"] == "malignant").astype(int)
        d.to_csv(root / "data" / f"PanNuke_{split}.csv", index=False)


def _tables(base):
    out = {}
    for name in ("performance_val.tsv", "performance_test_best_lr=*.tsv"):
        (path,) = list(base.rglob(name))
        out[name] = pd.read_csv(path, sep="\t", index_col=0)
    return out


def test_fine_tuning_train_cli(env, monkeypatch, tmp_path):
    root, _ = env
    _pannuke(root)
    real_init = tft.FineTuner.__init__

    def same_head(self, *args, **kw):  # the JAX tuner's head (its seed, its draw)
        real_init(self, *args, **kw)
        key = jax.random.fold_in(jax.random.PRNGKey(kw["seed"]), 1)
        head = jft.LinearClassifier.init(key, self.clip_cfg.embed_dim, self.num_classes)
        with torch.no_grad():
            self.model.head.kernel.copy_(torch.tensor(np.asarray(head["kernel"])))

    monkeypatch.setattr(tft.FineTuner, "__init__", same_head)
    argv = ["--dataset", "PanNuke", "--model_name", "plip", "--batch-size", "4",
            "--epochs", "2", "--num_workers", "2", "--lr_search", "1e-3"]
    (_, want), (_, got) = _run_both(monkeypatch, env, jfinetune.main, tfinetune.main,
                                    argv + ["--save_directory", str(tmp_path / "port")],
                                    argv + ["--save_directory", str(tmp_path / "jax")])
    assert list(got.columns) == list(want.columns)
    tables, jtables = _tables(tmp_path / "port"), _tables(tmp_path / "jax")
    for name, want_t in jtables.items():
        got_t = tables[name]
        assert list(got_t.columns) == list(want_t.columns) and len(got_t) == len(want_t) == 2
        np.testing.assert_allclose(got_t["loss"], want_t["loss"], rtol=1e-4)
        for col in ("f1_weighted", "f1_macro", "learning_rate", "epoch"):
            np.testing.assert_allclose(got_t[col], want_t[col], atol=1e-6)
    args = pd.read_csv(next((tmp_path / "port").rglob("arguments.csv")), index_col=0)
    assert args.loc["device", "Value"] == "cpu"
    assert list((tmp_path / "port").rglob("_training.log"))
    # skip-if-done: a second run with the same seed exits early
    _use(monkeypatch, env, "port")
    assert tfinetune.main(argv + ["--save_directory", str(tmp_path / "port"),
                                  "--device", "cpu"]) is None


def test_fine_tuning_analysis_cli(tmp_path):
    base = tmp_path / "fa"
    for seed, f1 in ((0, [0.5, 0.7]), (1, [0.6, 0.9])):
        run = (base / "PanNuke" / "train_ratio=1.0"
               / "PLIP_btch=128_wd=0.1_nepochs=10_validratio=0.3_optimizer=AdamW"
               / f"random_seed={seed}_20260101-00.00.0{seed}")
        run.mkdir(parents=True)
        pd.DataFrame({"epoch": [0, 1], "f1_weighted": f1, "f1_macro": [0.4, 0.6]}).to_csv(
            run / "performance_test_best_lr=0.001.tsv", sep="\t")
    argv = ["--save_directory", str(base), "--models", "plip", "vit_b_32", "--num_seeds", "2"]
    want = janalysis.main(argv)
    want_csv = (base / "__figures" / "perf_mean.csv").read_bytes()
    (base / "__figures" / "perf_mean.csv").unlink()
    got = tanalysis.main(argv)
    pd.testing.assert_frame_equal(got, want)
    assert got.loc["plip", ("PanNuke", 1)].startswith("0.800")
    assert (base / "__figures" / "perf_mean.csv").read_bytes() == want_csv
