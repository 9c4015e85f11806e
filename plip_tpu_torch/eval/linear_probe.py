"""Linear probing head: the port of ``plip_tpu.eval.linear_probe`` (the
reference harness's ``evaluation/linear_probing/linear_classifier.py``).

Two backends:

- ``"sklearn"`` (default): the reference's ``SGDClassifier(loss="log_loss",
  penalty="l2", alpha, max_iter=10000, class_weight="balanced",
  random_state)``, the paper's contract, imported when the probe is fit.
  Where scikit-learn is absent (the machine with the card) it raises an
  ``ImportError`` that names the ``"torch"`` backend; it never switches.
- ``"torch"``: the JAX package's ``"jax"`` backend in PyTorch. Full-batch
  multinomial logistic regression, Adam (lr 0.05, 2000 steps) on the mean
  class-balanced log loss plus ``alpha / 2 * |w|^2``, ``w`` drawn from
  ``torch.Generator(seed)`` (N(0, 0.01^2)), on ``device`` (the card unless
  the caller names another).

Labels are encoded as ``np.unique`` sorts them, as scikit-learn's
``LabelEncoder`` does; a test label the training labels lack raises.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils import resolve_device
from .metrics import eval_metrics

BACKENDS = ("sklearn", "torch")


def encode_labels(train_y, test_y):
    """(classes, train indices, test indices): ``LabelEncoder.fit_transform``
    and ``transform`` in numpy."""
    classes, train_idx = np.unique(np.asarray(train_y), return_inverse=True)
    test_y = np.asarray(test_y)
    test_idx = np.searchsorted(classes, test_y)
    unseen = (test_idx >= len(classes)) | (classes[np.minimum(test_idx, len(classes) - 1)]
                                           != test_y)
    if unseen.any():
        raise ValueError(f"y contains previously unseen labels: {np.unique(test_y[unseen])}")
    return classes, train_idx.reshape(-1), test_idx


class TorchLogisticRegression:
    """Class-balanced multinomial logistic regression with an L2 penalty
    (``alpha``), fit by full-batch Adam."""

    def __init__(self, alpha: float, seed: int, steps: int = 2000, lr: float = 0.05,
                 device=None):
        self.alpha = alpha
        self.seed = seed
        self.steps = steps
        self.lr = lr
        self.device = resolve_device(device, "LinearProber(backend='torch')")

    def objective(self, X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor, cls_w: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(X @ w + b, dim=-1)
        nll = -logp[torch.arange(X.shape[0], device=X.device), y] * cls_w[y]
        return nll.mean() + 0.5 * self.alpha * (w * w).sum()

    def fit(self, X, y):
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        y_np = np.asarray(y)
        y = torch.as_tensor(y_np, dtype=torch.long, device=self.device)
        n, d = X.shape
        k = int(y_np.max()) + 1
        counts = np.bincount(y_np, minlength=k)
        # scikit-learn's 'balanced': w_c = n / (k * count_c)
        cls_w = torch.as_tensor(n / (k * np.maximum(counts, 1)), dtype=torch.float32,
                                device=self.device)
        gen = torch.Generator().manual_seed(self.seed)
        w = (torch.randn((d, k), generator=gen) * 0.01).to(self.device).requires_grad_()
        b = torch.zeros(k, device=self.device, requires_grad=True)
        opt = torch.optim.Adam([w, b], lr=self.lr)
        with torch.enable_grad():
            for _ in range(self.steps):
                opt.zero_grad(set_to_none=True)
                self.objective(X, y, w, b, cls_w).backward()
                opt.step()
        self.w, self.b = w.detach(), b.detach()
        self.loss = float(self.objective(X, y, self.w, self.b, cls_w))  # the final objective
        return self

    def predict(self, X) -> np.ndarray:
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return (X @ self.w + self.b).argmax(-1).cpu().numpy()


class LinearProber:
    def __init__(self, alpha: float, seed: int = 7, backend: str = "sklearn", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.alpha = alpha
        self.seed = seed
        self.backend = backend
        self.device = device

    def classifier(self):
        if self.backend == "torch":
            return TorchLogisticRegression(self.alpha, self.seed, device=self.device)
        try:
            from sklearn.linear_model import SGDClassifier
        except ImportError as e:
            raise ImportError(
                "LinearProber(backend='sklearn') needs scikit-learn, which is not "
                "installed; pass backend='torch' for the PyTorch probe") from e
        return SGDClassifier(
            random_state=self.seed,
            loss="log_loss",
            alpha=self.alpha,
            verbose=0,
            penalty="l2",
            max_iter=10000,
            class_weight="balanced",
        )

    def train_and_test(
        self, train_x: List, train_y: List, test_x: List, test_y: List
    ) -> Tuple[object, Tuple[dict, dict]]:
        _, train_y, test_y = encode_labels(train_y, test_y)
        classifier = self.classifier()
        classifier.fit(train_x, train_y)
        test_pred = classifier.predict(test_x)
        train_pred = classifier.predict(train_x)

        test_metrics = eval_metrics(test_y, test_pred, average_method="macro")
        train_metrics = eval_metrics(train_y, train_pred, average_method="macro")
        test_metrics["split"] = "test"
        train_metrics["split"] = "train"
        return classifier, (test_metrics, train_metrics)
