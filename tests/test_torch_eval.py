"""The port's evaluation heads (``plip_tpu_torch.eval``) against
``plip_tpu.eval`` (CPU).

- ``eval_metrics`` and ``retrieval_metrics``: numpy in the port,
  scikit-learn in the JAX package. Every key equal to 1e-12 (NaN where the
  JAX package's is NaN) on binary, multiclass, string-label and degenerate
  cases (a class never predicted, constant predictions, one class), in both
  averages, with and without ``y_pred_proba``.
- ``ZeroShotClassifier`` and ``ImageRetrieval`` on the same embeddings.
- ``LinearProber``: the label encoding is ``LabelEncoder``'s; the default
  ``"sklearn"`` backend gives the JAX package's metrics; the ``"torch"``
  probe against the JAX package's ``"jax"`` probe on the same data: the final
  objective within 1e-3 relative (one reading: 3.6e-5) and at least 99% of
  the predictions equal (one reading: all).
"""

import contextlib
import math
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from plip_tpu.eval import linear_probe as jprobe
from plip_tpu.eval import metrics as jmetrics
from plip_tpu.eval.retrieval import ImageRetrieval as JRetrieval
from plip_tpu.eval.zero_shot import ZeroShotClassifier as JZeroShot
from plip_tpu_torch.eval import linear_probe as tprobe
from plip_tpu_torch.eval import metrics as tmetrics
from plip_tpu_torch.eval.retrieval import ImageRetrieval
from plip_tpu_torch.eval.zero_shot import ZeroShotClassifier


def _assert_same_metrics(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert g == w, k
        elif math.isnan(w):
            assert math.isnan(g), (k, g)
        else:
            assert abs(g - w) <= 1e-12, (k, g, w)


def _cases():
    rng = np.random.default_rng(0)
    yb = rng.integers(0, 2, 200)
    yb_pred = np.where(rng.random(200) < 0.8, yb, 1 - yb)
    proba = np.clip(yb * 0.6 + rng.random(200) * 0.5, 0, 1).round(2)  # ties included
    ym = rng.integers(0, 5, 300)
    ym_pred = np.where(rng.random(300) < 0.6, ym, rng.integers(0, 5, 300))
    names = np.array(["adipose", "debris", "lymphocytes", "mucus", "stroma"])
    return {
        "binary": (yb, yb_pred, None),
        "binary proba": (yb, yb_pred, proba),
        "binary -1/1 proba": (2 * yb - 1, 2 * yb_pred - 1, proba),
        "multiclass": (ym, ym_pred, None),
        "multiclass proba": (ym, ym_pred, rng.random(300)),
        "strings": (list(names[ym]), list(names[ym_pred]), None),
        "binary strings": (list(names[yb]), list(names[yb_pred]), None),
        "class never predicted": (ym, np.where(ym_pred == 3, 0, ym_pred), None),
        "label only predicted": (ym % 3, ym_pred, None),
        "constant predictions": (ym, np.full(300, 2), None),
        "constant binary": (yb, np.zeros(200, int), proba),
        "one class": (np.ones(50, int), np.ones(50, int), rng.random(50)),
        "one class, wrong": (np.zeros(50, int), np.ones(50, int), rng.random(50)),
        "perfect": (ym, ym, None),
    }


CASES = _cases()


@pytest.mark.parametrize("average", ["weighted", "macro"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_metrics_equal_jax(case, average):
    y_true, y_pred, proba = CASES[case]
    with _quiet():  # scikit-learn warns where a metric is undefined
        want = jmetrics.eval_metrics(y_true, y_pred, proba, average_method=average)
    got = tmetrics.eval_metrics(y_true, y_pred, proba, average_method=average)
    _assert_same_metrics(got, want)


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        yield


def test_auc_labels_outside_0_1_raise_as_sklearn():
    y = np.array([1, 2, 2, 1])
    with pytest.raises(ValueError, match="pos_label"):
        jmetrics.eval_metrics(y, y, np.arange(4.0))
    with pytest.raises(ValueError, match="pos_label"):
        tmetrics.eval_metrics(y, y, np.arange(4.0))


def test_retrieval_metrics_and_heads_equal_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((120, 16)).astype(np.float32)
    txt = (img + rng.standard_normal((120, 16)) * 1.5).astype(np.float32)
    for a, b in zip(ImageRetrieval().retrieval(img, txt), JRetrieval().retrieval(img, txt)):
        assert a == b
    small = img[:30], txt[:30]  # fewer than 50 images
    assert ImageRetrieval().retrieval(*small) == JRetrieval().retrieval(*small)
    preds = [rng.permutation(120)[:60] for _ in range(40)]
    targets = list(rng.integers(0, 120, 40))
    assert tmetrics.retrieval_metrics(targets, preds) == jmetrics.retrieval_metrics(targets, preds)


def test_zero_shot_head_equals_jax():
    rng = np.random.default_rng(2)
    labels = ["benign", "malignant", "stroma"]
    txt = rng.standard_normal((3, 8))
    target = list(rng.choice(labels, 60))
    img = np.stack([txt[labels.index(t)] for t in target]) + rng.standard_normal((60, 8)) * 1.2
    got = ZeroShotClassifier().zero_shot_classification(img, txt, labels, target)
    with _quiet():
        want = JZeroShot().zero_shot_classification(img, txt, labels, target)
    for g, w in zip(got, want):
        _assert_same_metrics(g, w)
    assert got[1]["split"] == "test" and got[0]["split"] == "train"


def test_label_encoding_is_label_encoders():
    from sklearn.preprocessing import LabelEncoder

    train = ["stroma", "adipose", "mucus", "adipose", "stroma"]
    test = ["mucus", "stroma", "adipose"]
    classes, tr, te = tprobe.encode_labels(train, test)
    le = LabelEncoder().fit(train)
    np.testing.assert_array_equal(classes, le.classes_)
    np.testing.assert_array_equal(tr, le.transform(train))
    np.testing.assert_array_equal(te, le.transform(test))
    for unseen in (["tumor"], ["zzz", "adipose"], ["aaa"]):
        with pytest.raises(ValueError, match="unseen"):
            tprobe.encode_labels(train, unseen)
        with pytest.raises(ValueError):
            le.transform(unseen)


@pytest.fixture
def one_thread():
    """The probes run 2,000 steps of small ops: one intra-op thread, so that
    the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def probe_data():
    """Three overlapping Gaussian classes in 32 dims, unit-normalized rows as
    the embedders give them; string labels."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((3, 32))
    y = rng.integers(0, 3, 360)
    x = centers[y] + rng.standard_normal((360, 32)) * 1.6
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    names = np.array(["debris", "lymphocytes", "tumor"])[y]
    return x[:240], list(names[:240]), x[240:], list(names[240:])


def test_sklearn_probe_equals_jax(probe_data):
    tx, ty, vx, vy = probe_data
    with _quiet():
        _, want = jprobe.LinearProber(alpha=0.01, seed=1).train_and_test(tx, ty, vx, vy)
        _, got = tprobe.LinearProber(alpha=0.01, seed=1).train_and_test(tx, ty, vx, vy)
    for g, w in zip(got, want):
        _assert_same_metrics(g, w)


def _objective(X, y, w, b, alpha):
    """The probes' objective in float64 numpy."""
    X, w, b = (np.asarray(a, np.float64) for a in (X, w, b))
    n, k = len(y), w.shape[1]
    cls_w = n / (k * np.maximum(np.bincount(y, minlength=k), 1))
    z = X @ w + b
    z = z - z.max(1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(1, keepdims=True))
    return float((-logp[np.arange(n), y] * cls_w[y]).mean() + 0.5 * alpha * (w * w).sum())


def test_torch_probe_against_jax_probe(probe_data, one_thread):
    tx, ty, vx, vy = probe_data
    _, ytr, yte = tprobe.encode_labels(ty, vy)
    jfit = jprobe._JaxLogisticRegression(0.01, 1).fit(tx, ytr)
    tfit = tprobe.TorchLogisticRegression(0.01, 1, device="cpu").fit(tx, ytr)
    want = _objective(tx, ytr, jfit.params["w"], jfit.params["b"], 0.01)
    got = _objective(tx, ytr, tfit.w.numpy(), tfit.b.numpy(), 0.01)
    assert abs(got - want) <= 1e-3 * abs(want), (got, want)
    assert abs(tfit.loss - got) <= 1e-5 * got
    both = np.concatenate([tx, vx])
    same = (tfit.predict(both) == jfit.predict(both)).mean()
    assert same >= 0.99, same
    print(f"objective: torch {got:.9f}, jax {want:.9f} ({abs(got - want) / want:.3g} "
          f"relative); predictions equal on {same:.4f}")
    # the whole probe: seeded, so it is the fit above
    prober = tprobe.LinearProber(alpha=0.01, seed=1, backend="torch", device="cpu")
    _, (test_m, train_m) = prober.train_and_test(tx, ty, vx, vy)
    assert test_m == {**tmetrics.eval_metrics(yte, tfit.predict(vx), average_method="macro"),
                      "split": "test"}
    assert train_m["split"] == "train" and test_m["Accuracy"] > 0.6


def test_probe_backends_and_missing_sklearn(monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        tprobe.LinearProber(alpha=0.01, backend="jax")
    monkeypatch.setitem(sys.modules, "sklearn.linear_model", None)  # as if not installed
    with pytest.raises(ImportError, match="backend='torch'"):
        tprobe.LinearProber(alpha=0.01).classifier()
    monkeypatch.setattr(tprobe.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tprobe.LinearProber(alpha=0.01, backend="torch").classifier()


def test_eval_modules_import_no_sklearn_or_pandas():
    code = ("import sys\n"
            "import plip_tpu_torch.eval.metrics, plip_tpu_torch.eval.zero_shot\n"
            "import plip_tpu_torch.eval.retrieval, plip_tpu_torch.eval.linear_probe\n"
            "import numpy as np\n"
            "from plip_tpu_torch.eval.metrics import eval_metrics\n"
            "from plip_tpu_torch.eval.linear_probe import LinearProber\n"
            "eval_metrics([0, 1, 1, 0], [0, 1, 0, 0], [0.1, 0.9, 0.4, 0.2])\n"
            "x = np.random.default_rng(0).standard_normal((40, 4))\n"
            "y = ['a', 'b'] * 20\n"
            "p = LinearProber(0.01, backend='torch', device='cpu')\n"
            "p.classifier = lambda: __import__('plip_tpu_torch.eval.linear_probe', "
            "fromlist=['x']).TorchLogisticRegression(0.01, 0, steps=5, device='cpu')\n"
            "p.train_and_test(x, y, x, y)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'pandas', 'jax', 'plip_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
