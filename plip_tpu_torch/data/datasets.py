"""Datasets of the trainers and embedders: the port's own copy of
``load_image_rgb``, ``ImageCaptionDataset``, ``CaptionDataset``,
``ImageDataset`` and ``ImageLabelDataset`` from ``plip_tpu.data.datasets``,
which it does not import, and the four names the reference's embedders
import them by (``CLIPImageCaptioningDataset`` and the others, at the end).

Plain indexable objects whose items are host numpy, consumed by the
prefetching loader (``data/loader.py``), with the reference's PIL robustness
settings (truncated files tolerated, no pixel-count limit).
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Sequence

import numpy as np

try:
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def load_image_rgb(path_or_img) -> np.ndarray:
    """Path/PIL/array -> HWC uint8 RGB numpy.

    JPEG paths go through the native libjpeg pool (``plip_tpu_torch.native``)
    when it is built (bit-identical to PIL's decode); anything else, or a
    failure there, is opened with PIL."""
    if isinstance(path_or_img, np.ndarray):
        arr = path_or_img
    elif hasattr(path_or_img, "convert"):
        arr = np.asarray(path_or_img.convert("RGB"))
    else:
        arr = None
        if str(path_or_img).lower().endswith((".jpg", ".jpeg")):
            from .. import native

            if native.available():
                arr = native.decode_jpeg(str(path_or_img))
        if arr is None:
            if not _HAS_PIL:
                raise RuntimeError("PIL required to open image paths")
            arr = np.asarray(Image.open(path_or_img).convert("RGB"))
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr.astype(np.uint8)


def _accepts_index(preprocessing) -> bool:
    """True when ``preprocessing(img, index=i)`` is supported, so a per-item
    seeded transform (``data.transform.TrainTransform``) draws the same crop
    whichever loader thread runs it."""
    if preprocessing is None:
        return False
    try:
        return "index" in inspect.signature(preprocessing).parameters
    except (TypeError, ValueError):
        return False


class ImageCaptionDataset:
    """Columns ``image`` and ``caption`` of ``df`` (a DataFrame or a dict of
    lists)."""

    def __init__(self, df, preprocessing: Optional[Callable] = None):
        self.images: List = list(df["image"])
        self.captions: List = list(df["caption"])
        self.preprocessing = preprocessing
        self._wants_index = _accepts_index(preprocessing)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        img = load_image_rgb(self.images[idx])
        if self.preprocessing is not None:
            img = (self.preprocessing(img, index=idx)
                   if self._wants_index else self.preprocessing(img))
        return img, self.captions[idx]


class CaptionDataset:
    """Caption-only (internal_datasets.py:21-30)."""

    def __init__(self, captions: Sequence[str]):
        self.captions = list(captions)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        return self.captions[idx]


class ImageDataset:
    """Image-only (internal_datasets.py:33-43).

    on_error: "raise" (default) propagates decode failures through the loader;
    "zero" substitutes a zero tile (order and shapes preserved) and records
    the index in ``failed_indices``.
    """

    def __init__(
        self,
        list_of_images: Sequence,
        preprocessing: Optional[Callable] = None,
        on_error: str = "raise",
        zero_shape=(224, 224, 3),
    ):
        self.images = list(list_of_images)
        self.preprocessing = preprocessing
        self.on_error = on_error
        self.zero_shape = zero_shape
        self.failed_indices: List[int] = []
        self._wants_index = _accepts_index(preprocessing)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        try:
            img = load_image_rgb(self.images[idx])
        except Exception:
            if self.on_error != "zero":
                raise
            self.failed_indices.append(idx)
            img = np.zeros(self.zero_shape, np.uint8)
        if self.preprocessing is not None:
            img = (self.preprocessing(img, index=idx)
                   if self._wants_index else self.preprocessing(img))
        return img


class ImageLabelDataset:
    """Columns ``image`` and ``label`` of ``df`` (internal_datasets.py:46-58)."""

    def __init__(self, df, preprocessing: Optional[Callable] = None):
        self.images: List = list(df["image"])
        self.labels: List = list(df["label"])
        self.preprocessing = preprocessing
        self._wants_index = _accepts_index(preprocessing)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = load_image_rgb(self.images[idx])
        if self.preprocessing is not None:
            img = (self.preprocessing(img, index=idx)
                   if self._wants_index else self.preprocessing(img))
        return img, self.labels[idx]


# The reference's names (internal_datasets.py:6,21,33,46)
CLIPImageCaptioningDataset = ImageCaptionDataset
CLIPCaptioningDataset = CaptionDataset
CLIPImageDataset = ImageDataset
CLIPImageLabelDataset = ImageLabelDataset
