"""Item transforms of the trainer: the port of ``plip_tpu.data.transform``
(which imports JAX through ``plip_tpu.ops.augment``, so it is copied here).

- ``eval_transform(n_px)``: the decoded uint8 image as it is; resize, crop
  and normalize run batched on the device (``ops.preprocess``).
- ``TrainTransform``: the host half of the train pipeline, a shortest-side
  resize to ``first_resize`` and a random square crop of the long side, so
  batches stack; the rest runs on the device (``ops.augment``). Its crops are
  the JAX package's, bit for bit: each item's generator comes from
  ``SeedSequence([seed, epoch, index])``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..ops.resize import torchvision_resized_dims


def eval_transform(n_px: int = 224) -> Callable:
    """Item transform: raw uint8 HWC out (the device does the rest)."""

    def fn(img_u8: np.ndarray) -> np.ndarray:
        return img_u8

    fn.n_px = n_px
    return fn


@dataclasses.dataclass
class TrainTransform:
    """Shortest-side resize to ``first_resize`` (PIL bicubic) and a random
    square crop of the long side. The crop is stateless per item, drawn from
    ``(seed, epoch, index)``, so it does not depend on which loader thread
    runs it; bump ``epoch`` between epochs for fresh crops (CLIPTuner does)."""

    first_resize: int = 512
    n_px: int = 224
    seed: int = 0
    epoch: int = 0

    def __call__(self, img_u8: np.ndarray, index: int = 0) -> np.ndarray:
        from PIL import Image

        h, w = img_u8.shape[:2]
        rh, rw = torchvision_resized_dims(h, w, self.first_resize)
        if (rh, rw) != (h, w):
            img_u8 = np.asarray(Image.fromarray(img_u8).resize((rw, rh), Image.BICUBIC))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, index]))
        if rh > self.first_resize:
            top = int(rng.integers(0, rh - self.first_resize + 1))
            img_u8 = img_u8[top:top + self.first_resize]
        if rw > self.first_resize:
            left = int(rng.integers(0, rw - self.first_resize + 1))
            img_u8 = img_u8[:, left:left + self.first_resize]
        return np.ascontiguousarray(img_u8)
