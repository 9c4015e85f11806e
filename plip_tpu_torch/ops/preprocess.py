"""Image preprocessing on the device: resize -> crop -> rescale -> normalize.

The port of ``plip_tpu.ops.preprocess``. PIL's bicubic resize with the center
crop composed in is a pair of dense matrices (``ops.resize``, the port's copy
of ``plip_tpu.ops.resize``, so both packages resample with the same numbers); on
the device it is two matmuls, each followed by PIL's uint8 store (round half
up, clip to [0, 255]), then the CLIP normalize. The matmuls run in fp32: a
TF32 product (``torch.backends.cuda.matmul.allow_tf32``) would move values
across the rounding boundaries. ``fused=True`` takes the one-kernel
formulation instead (``ops.preprocess_fused``, the port of the JAX package's
``use_pallas=True``); this two-matmul path is its plain version.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np
import torch

from ..models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from ..utils.profiling import span
from .resize import resize_crop_matrices

# torchvision's ImageNet statistics (the mudipath embedder's normalize)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _quant(v: torch.Tensor, emulate_uint8: bool) -> torch.Tensor:
    """PIL's uint8 store: round half up, clip to [0, 255]."""
    return torch.clamp(torch.floor(v + 0.5), 0.0, 255.0) if emulate_uint8 else v


def preprocess_batch(
    images: Union[np.ndarray, torch.Tensor],
    out_size: int = 224,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
    fused: bool = False,
    emulate_uint8: bool = True,
) -> torch.Tensor:
    """Uniform-shape batch ``[B, H, W, 3]`` uint8 RGB -> ``[B, out, out, 3]``
    on ``device`` (default: the images' own device). ``fused``: one kernel
    (``ops.preprocess_fused.preprocess_batch_fused``, which truncates other
    dtypes into uint8 first, as the JAX package's kernel wrapper does).
    ``emulate_uint8=False`` drops PIL's two uint8 stores (the JAX package's
    ``_preprocess_same_shape`` switch)."""
    with span("preprocess.h2d"):
        images = torch.as_tensor(images, device=device)
    if images.dim() == 3:
        images = images[None]
    with span("preprocess.resize"):
        if fused:
            from .preprocess_fused import preprocess_batch_fused  # imports this module

            return preprocess_batch_fused(images, out_size, mean, std, emulate_uint8, dtype)
        _, h, w, _ = images.shape
        R, C = (torch.from_numpy(m).to(images.device)
                for m in resize_crop_matrices(h, w, out_size, out_size))
        x = images.float()
        # PIL runs the width pass first, then the height pass.
        x = _quant(torch.einsum("jx,byxc->byjc", C, x), emulate_uint8)
        x = _quant(torch.einsum("iy,byjc->bijc", R, x), emulate_uint8)
        m, s = normalize_constants(mean, std, x.device)
        return ((x - m) / s).to(dtype)


def normalize_constants(mean: tuple, std: tuple, device) -> tuple:
    """(255 mean, 255 std): fp32 ``[3]`` tensors on ``device``."""
    return (torch.tensor(mean, device=device) * 255.0,
            torch.tensor(std, device=device) * 255.0)


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
        with span("preprocess.stack"):
            batch = np.stack(arrays)
        return preprocess_batch(batch, out_size, mean, std, dtype, device)

    out = None
    for idxs in groups.values():
        with span("preprocess.stack"):
            batch = np.stack([arrays[i] for i in idxs])
        part = preprocess_batch(batch, out_size, mean, std, dtype, device)
        if out is None:
            out = part.new_empty((len(arrays),) + tuple(part.shape[1:]))
        out[torch.as_tensor(idxs, device=part.device)] = part
    return out
