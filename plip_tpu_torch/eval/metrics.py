"""Evaluation metrics in numpy: the port of ``plip_tpu.eval.metrics``.

The same keys and values as the JAX package's functions, which call
scikit-learn (and, through them, as the reference harness's
``reproducibility/metrics.py``), so results CSVs compare drop-in. The
formulas are scikit-learn's, written out in numpy so that the default path
imports no scikit-learn (the machine with the card has none):

- accuracy: the share of equal labels;
- precision, recall and F1 per label over the sorted union of the labels
  (``2 tp / (true + predicted)`` for F1), 0 where a denominator is 0, then
  weighted by true support (``"weighted"``) or plainly averaged
  (``"macro"``);
- MCC: the multiclass form over the confusion matrix, 0 where it is
  undefined;
- AUC: the trapezoid area under the binary ROC curve of ``y_pred_proba``
  (labels in {0, 1} or {-1, 1}, positive 1), NaN for more than two classes
  or one class;
- tp/fp/tn/fn over the labels 0 and 1, as the reference counts them (string
  labels count none), and the rates derived from them, NaN where undefined.

Only ``verbose=True`` imports scikit-learn, for its ``classification_report``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def retrieval_metrics(y_target: Sequence, y_predictions: Sequence) -> Dict[str, float]:
    """The share of queries whose target is in the top 10 / top 50."""
    p_10 = 0
    p_50 = 0
    for t, predictions in zip(y_target, y_predictions):
        predictions = np.asarray(predictions)
        if t in predictions[:10]:
            p_10 += 1
        if t in predictions[:50]:
            p_50 += 1
    n = len(y_target)
    return {"p@10": p_10 / n, "p@50": p_50 / n}


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (scikit-learn's ``zero_division=0``)."""
    num, den = num.astype(np.float64), den.astype(np.float64)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den != 0)
    return out


def _indices(y_true: np.ndarray, y_pred: np.ndarray):
    """(true, predicted) as indices into the sorted union of their labels,
    and its size."""
    labels = np.unique(np.concatenate([y_true, y_pred]))
    return np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred), len(labels)


def _prf(y_true: np.ndarray, y_pred: np.ndarray, average: str):
    """(precision, recall, F1) averaged over the labels."""
    t, p, n = _indices(y_true, y_pred)
    tp_sum = np.bincount(t[t == p], minlength=n)
    pred_sum = np.bincount(p, minlength=n)
    true_sum = np.bincount(t, minlength=n)
    precision = _divide(tp_sum, pred_sum)
    recall = _divide(tp_sum, true_sum)
    f1 = _divide(2 * tp_sum, true_sum + pred_sum)
    if average == "weighted":
        weights = true_sum
    elif average == "macro":
        weights = None
    else:
        raise ValueError(f"average must be 'weighted' or 'macro', got {average!r}")
    return tuple(float(np.average(v, weights=weights)) for v in (precision, recall, f1))


def _mcc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    t, p, n = _indices(y_true, y_pred)
    C = np.bincount(t * n + p, minlength=n * n).reshape(n, n)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n_samples = p_sum.sum()
    cov_ytyp = n_correct * n_samples - np.dot(t_sum, p_sum)
    cov_ypyp = n_samples**2 - np.dot(p_sum, p_sum)
    cov_ytyt = n_samples**2 - np.dot(t_sum, t_sum)
    cov_ypyp_ytyt = cov_ypyp * cov_ytyt
    if cov_ypyp_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ypyp_ytyt))


def _binary_auc(y_true: np.ndarray, y_score) -> float:
    """The area under the ROC curve of scores for the positive label 1."""
    classes = np.unique(y_true)
    if classes.dtype.kind in "OUS" or not any(
            np.array_equal(classes, c) for c in ([0, 1], [-1, 1], [0], [-1], [1])):
        raise ValueError(
            f"y_true takes value in {{{', '.join(map(repr, classes.tolist()))}}} and "
            "pos_label is not specified: either make y_true take value in {0, 1} or "
            "{-1, 1} or pass pos_label explicitly.")
    score = np.asarray(y_score)
    if score.ndim == 2 and score.shape[1] == 1:
        score = score[:, 0]
    if score.ndim != 1 or len(score) != len(y_true):
        raise ValueError(f"y_pred_proba of shape {score.shape} for {len(y_true)} labels")
    order = np.argsort(score, kind="mergesort")[::-1]
    score, pos = score[order], (y_true[order] == 1).astype(np.float64)
    ends = np.r_[np.where(np.diff(score))[0], len(score) - 1]  # one point a distinct score
    tps = np.cumsum(pos, dtype=np.float64)[ends]
    fps = 1 + ends - tps
    if tps[-1] == 0 or fps[-1] == 0:  # one class only: the curve is undefined
        return float("nan")
    tpr = np.r_[0.0, tps / tps[-1]]
    fpr = np.r_[0.0, fps / fps[-1]]
    return float((np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0).sum())  # the trapezoid rule


def eval_metrics(
    y_true,
    y_pred,
    y_pred_proba: Optional[np.ndarray] = None,
    average_method: str = "weighted",
    verbose: bool = False,
) -> Dict[str, float]:
    """The classification metric dict: accuracy, binary AUROC (NaN for more
    than two classes, as the reference), F1/precision/recall averaged by
    ``average_method``, MCC, and the tp/fp/tn/fn-derived sensitivity,
    specificity, ppv and npv."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    assert len(y_true) == len(y_pred)

    if y_pred_proba is None or len(np.unique(y_true)) > 2:
        auroc = np.nan  # the reference: 'Multiclass AUC is not currently available.'
    else:
        auroc = _binary_auc(y_true, y_pred_proba)

    precision, recall, f1 = _prf(y_true, y_pred, average_method)
    if verbose:
        from sklearn.metrics import classification_report

        print(classification_report(y_true, y_pred))
    mcc = _mcc(y_true, y_pred)
    acc = float(np.average(y_true == y_pred))

    # binary confusion counts over the labels 0 and 1; other labels count none
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    fp = int(np.sum((y_pred == 1) & (y_true != y_pred)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    fn = int(np.sum((y_pred == 0) & (y_true != y_pred)))

    sensitivity = tp / (tp + fn) if (tp + fn) else np.nan
    specificity = tn / (tn + fp) if (tn + fp) else np.nan
    ppv = tp / (tp + fp) if (tp + fp) else np.nan
    npv = tn / (tn + fn) if (tn + fn) else np.nan
    total = tp + tn + fp + fn
    hitrate = (tp + tn) / total if total else np.nan

    return {
        "Accuracy": acc,
        "AUC": auroc,
        "WF1": f1,
        "precision": precision,
        "recall": recall,
        "mcc": mcc,
        "tp": tp,
        "fp": fp,
        "tn": tn,
        "fn": fn,
        "sensitivity": sensitivity,
        "specificity": specificity,
        "ppv": ppv,
        "npv": npv,
        "hitrate": hitrate,
        "instances": len(y_true),
    }
