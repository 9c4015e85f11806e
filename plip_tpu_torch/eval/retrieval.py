"""Text -> image retrieval head: a numpy copy of ``plip_tpu.eval.retrieval``
(the reference harness's ``evaluation/retrieval/retrieval.py``). Each text
query ranks the images by dot product, top 50 descending; query i's target
is image i; p@10 and p@50."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .metrics import retrieval_metrics


class ImageRetrieval:
    def __init__(self):
        pass

    def retrieval(
        self, image_embeddings: np.ndarray, text_embeddings: np.ndarray
    ) -> Tuple[dict, dict]:
        img = np.asarray(image_embeddings)
        txt = np.asarray(text_embeddings)
        scores = txt @ img.T  # [Q, N]
        k = min(50, img.shape[0])
        # the top k of each row, descending: argpartition, then a stable sort
        part = np.argpartition(-scores, kth=k - 1, axis=1)[:, :k]
        row_scores = np.take_along_axis(scores, part, axis=1)
        order = np.argsort(-row_scores, axis=1, kind="stable")
        best_scores = np.take_along_axis(part, order, axis=1)

        targets = list(range(img.shape[0]))
        test_metrics = retrieval_metrics(targets, best_scores)
        train_metrics = dict(test_metrics)
        test_metrics["split"] = "test"
        train_metrics["split"] = "train"
        return train_metrics, test_metrics
