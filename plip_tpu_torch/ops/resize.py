"""Bicubic resize as matrix multiplication: the port's own copy of
``plip_tpu.ops.resize``, which it does not import.

The reference preprocesses with PIL/torchvision ``Resize(224, BICUBIC)`` +
``CenterCrop(224)``. PIL's resampling is a separable convolution with
per-output-pixel weight windows, i.e. exactly a pair of small dense matrices.
They are computed on the host (PIL's conventions: Keys cubic a=-0.5, support
scaled by the downscale factor = inherent antialiasing, window clipping +
renormalization at the borders) and the resize runs as two batched matmuls on
the device (``ops/preprocess.py``). The center crop composes into the
matrices: only the output rows/cols inside the crop window are kept.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel (PIL's BICUBIC filter), support 2."""
    x = np.abs(x)
    out = np.where(
        x < 1.0,
        (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0,
        np.where(x < 2.0, a * (x**3 - 5.0 * x**2 + 8.0 * x - 4.0), 0.0),
    )
    return out


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] PIL-convention bicubic resampling matrix."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        w = _cubic((xs - center + 0.5) * ss)
        s = w.sum()
        if s != 0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


def torchvision_resized_dims(h: int, w: int, shortest: int) -> Tuple[int, int]:
    """Output dims of torchvision ``Resize(int)``: shortest side -> `shortest`,
    other side scaled preserving aspect ratio (already-short sides unchanged)."""
    if h <= w:
        if h == shortest:
            return h, w
        return shortest, max(1, int(shortest * w / h))
    if w == shortest:
        return h, w
    return max(1, int(shortest * h / w)), shortest


def crop_offsets(rh: int, rw: int, crop: int) -> Tuple[int, int]:
    """torchvision CenterCrop offsets (int(round(...)) convention)."""
    return int(round((rh - crop) / 2.0)), int(round((rw - crop) / 2.0))


@functools.lru_cache(maxsize=256)
def resize_crop_matrices(
    in_h: int, in_w: int, shortest: int = 224, crop: int = 224
) -> Tuple[np.ndarray, np.ndarray]:
    """Row/col matrices implementing Resize(shortest)+CenterCrop(crop).

    Returns (R [crop, in_h], C [crop, in_w]) such that
    ``out = R @ img @ C.T`` per channel.
    """
    rh, rw = torchvision_resized_dims(in_h, in_w, shortest)
    top, left = crop_offsets(rh, rw, crop)
    R_full = resize_matrix(in_h, rh)
    C_full = resize_matrix(in_w, rw)
    # Crop may exceed the resized extent for extreme aspect ratios; clamp.
    top = max(0, min(top, rh - crop)) if rh >= crop else 0
    left = max(0, min(left, rw - crop)) if rw >= crop else 0
    if rh < crop or rw < crop:
        raise ValueError(
            f"Resized image ({rh}x{rw}) smaller than crop {crop}; "
            "pad-crop of tiny images is not supported on the device path"
        )
    return R_full[top : top + crop], C_full[left : left + crop]
