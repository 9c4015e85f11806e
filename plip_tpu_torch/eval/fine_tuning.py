"""Fine-tuning evaluation head: the port of ``plip_tpu.eval.fine_tuning``.

The reference ships an empty placeholder here (``evaluation/fine_tuning/
fine_tuning_classifier.py:5-13``); this is the working equivalent, with
``LinearProber``'s ``train_and_test`` shape, driving the supervised
``FineTuner`` over image paths. Labels are encoded with the port's numpy
``encode_labels`` (scikit-learn's ``LabelEncoder`` in the JAX package).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

import numpy as np

from .linear_probe import encode_labels
from .metrics import eval_metrics


class FineTuningClassifier:
    def __init__(
        self,
        model_name: str = "plip",
        backbone: str = None,
        lr: float = 1e-4,
        epochs: int = 3,
        batch_size: int = 32,
        optimizer: str = "AdamW",
        seed: int = 0,
        device=None,
    ):
        self.kw = dict(
            model_name=model_name, backbone=backbone, lr=lr, epochs=epochs,
            batch_size=batch_size, optimizer=optimizer, seed=seed,
        )
        self.device = device

    def train_and_test(
        self, train_x: List[str], train_y: List, test_x: List[str], test_y: List
    ) -> Tuple[object, Tuple[dict, dict]]:
        """train_x/test_x: image paths; labels get label-encoded."""
        import pandas as pd

        from ..data.datasets import ImageLabelDataset
        from ..data.loader import PrefetchLoader
        from ..train.finetune import FineTuner

        classes, ytr, yte = encode_labels(train_y, test_y)
        train_df = pd.DataFrame({"image": train_x, "label": ytr})
        test_df = pd.DataFrame({"image": test_x, "label": yte})

        args = SimpleNamespace(
            model_name=self.kw["model_name"],
            optimizer=self.kw["optimizer"],
            PC_CLIP_ARCH="ViT-B/32",
        )
        ft = FineTuner(
            args=args,
            backbone=self.kw["backbone"],
            num_classes=len(classes),
            lr=self.kw["lr"],
            seed=self.kw["seed"],
            device=self.device,
        )
        ft.tuner(
            train_df, test_df, batch_size=self.kw["batch_size"],
            epochs=self.kw["epochs"], evaluation_steps=0,
        )

        def predict(df):  # final predictions on both splits
            outs = []
            loader = PrefetchLoader(ImageLabelDataset(df), self.kw["batch_size"],
                                    device=ft.device)
            for (images, _), n in loader:
                outs.append(ft.logits(images[:n]).cpu().numpy())
            return np.argmax(np.concatenate(outs), axis=1)

        test_metrics = eval_metrics(yte, predict(test_df), average_method="macro")
        train_metrics = eval_metrics(ytr, predict(train_df), average_method="macro")
        test_metrics["split"] = "test"
        train_metrics["split"] = "train"
        return ft, (test_metrics, train_metrics)
