"""Image preprocessing on the device: resize -> crop -> rescale -> normalize.

The port of ``plip_tpu.ops.preprocess``. PIL's bicubic resize with the center
crop composed in is a pair of dense matrices (``plip_tpu.ops.resize``, shared
with the JAX package, so both packages resample with the same numbers); on
the device it is two matmuls, each followed by PIL's uint8 store (round half
up, clip to [0, 255]), then the CLIP normalize. The matmuls run in fp32: a
TF32 product (``torch.backends.cuda.matmul.allow_tf32``) would move values
across the rounding boundaries.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from plip_tpu.ops.resize import resize_crop_matrices

from ..models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def _quant(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor(v + 0.5), 0.0, 255.0)


def preprocess_batch(
    images: Union[np.ndarray, torch.Tensor],
    out_size: int = 224,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Uniform-shape batch ``[B, H, W, 3]`` uint8 RGB -> ``[B, out, out, 3]``
    on ``device`` (default: the images' own device)."""
    images = torch.as_tensor(images, device=device)
    if images.dim() == 3:
        images = images[None]
    _, h, w, _ = images.shape
    R, C = (torch.from_numpy(m).to(images.device)
            for m in resize_crop_matrices(h, w, out_size, out_size))
    x = images.float()
    # PIL runs the width pass first, then the height pass.
    x = _quant(torch.einsum("jx,byxc->byjc", C, x))
    x = _quant(torch.einsum("iy,byjc->bijc", R, x))
    m = torch.tensor(mean, device=x.device) * 255.0
    s = torch.tensor(std, device=x.device) * 255.0
    return ((x - m) / s).to(dtype)


def preprocess_images(
    images: Sequence,
    out_size: int = 224,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Host images (PIL / numpy HWC uint8, any mix of sizes) ->
    ``[N, out, out, 3]`` on ``device``, in input order. Images of one size
    go through ``preprocess_batch`` together."""
    arrays: List[np.ndarray] = []
    for im in images:
        if hasattr(im, "convert"):  # PIL
            im = im.convert("RGB")
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        arrays.append(im)

    groups = {}
    for idx, arr in enumerate(arrays):
        groups.setdefault(arr.shape[:2], []).append(idx)
    if len(groups) == 1:
        return preprocess_batch(np.stack(arrays), out_size, mean, std, dtype, device)

    out = None
    for idxs in groups.values():
        part = preprocess_batch(np.stack([arrays[i] for i in idxs]), out_size, mean,
                                std, dtype, device)
        if out is None:
            out = part.new_empty((len(arrays),) + tuple(part.shape[1:]))
        out[torch.as_tensor(idxs, device=part.device)] = part
    return out
