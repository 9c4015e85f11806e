"""Zero-shot classification head on precomputed embeddings: a numpy copy of
``plip_tpu.eval.zero_shot`` (the reference harness's
``evaluation/zero_shot/zero_shot.py`` without its leftover debug
``pickle.dump`` and ``exit()``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .metrics import eval_metrics


class ZeroShotClassifier:
    def __init__(self):
        pass

    def zero_shot_classification(
        self,
        image_embeddings: np.ndarray,
        text_embeddings: np.ndarray,
        unique_labels: Sequence,
        target_labels: Sequence,
        verbose: bool = False,
    ) -> Tuple[dict, dict]:
        score = np.asarray(image_embeddings) @ np.asarray(text_embeddings).T
        idx = np.argmax(score, axis=1)
        unique_labels = list(unique_labels)
        predictions = [unique_labels[i] for i in idx]

        test_metrics = eval_metrics(target_labels, predictions, verbose=verbose)
        train_metrics = dict(test_metrics)
        test_metrics["split"] = "test"
        train_metrics["split"] = "train"
        return train_metrics, test_metrics
