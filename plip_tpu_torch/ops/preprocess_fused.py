"""Image preprocessing in one CUDA kernel: ``preprocess_batch_fused``.

The port of ``plip_tpu.ops.preprocess_pallas`` (K11, ``_kernel``): uint8
``[B, H, W, 3]`` in, fp32 ``[B, out, out, 3]`` out, with the width pass,
PIL's uint8 store, the height pass, the store again and the CLIP normalize
in one launch (``csrc/preprocess.cu``). The width pass's rows stay in shared
memory. ``ops.preprocess.preprocess_batch(fused=True)`` reaches it, as the
JAX package's ``use_pallas=True`` reaches K11; the default two-matmul path
(``preprocess_batch``) is its plain version.

The kernel reads uint8 as it is: the TPU kernel's int8 shift existed because
Mosaic had no u8 -> f32 cast. Both passes are full fp32 on CUDA cores, and
each sum runs over the nonzero extent of its row of the resize matrices
(the bicubic support), found here on the host: the skipped terms are exact
zeros. The JAX wrapper truncates a float input (``astype(int32)``); this one
takes uint8 only and raises otherwise.

On a CUDA tensor ``preprocess_batch_fused`` launches the kernel or raises;
on the CPU it is the plain version. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Union

import numpy as np
import torch

from . import _build
from ..models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from .attention import _on_cpu, _stream
from .preprocess import normalize_constants, preprocess_batch
from .resize import resize_crop_matrices

LAUNCHES = {"preprocess_fused": 0}

# Output rows a block takes at most, and the shared memory its width-pass
# rows may use before fewer rows are taken (the kernel's limit is 227 KB).
ROWS = 16
SMEM_TARGET = 96 * 1024
MAX_SMEM = 227 * 1024

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # img, R, C, r_lo, r_hi, c_lo, c_hi, out, B, H, W, n_out, rows, ny_max,
    # mean x3, std x3, emulate, device, stream
    "plip_preprocess": (_vp,) * 8 + (_int,) * 6 + (_float,) * 6 + (_int, _int, _vp),
}
_kernels = None


def reset_launch_counts() -> None:
    LAUNCHES["preprocess_fused"] = 0


def _lib() -> ctypes.CDLL:
    global _kernels
    if _kernels is None:
        _kernels = _build.bind(_SIGNATURES)
    return _kernels


def _extents(m: np.ndarray):
    """[lo, hi) of the nonzero entries of each row of ``m`` (0, 0 if none)."""
    nz = m != 0
    any_nz = nz.any(1)
    lo = np.where(any_nz, nz.argmax(1), 0)
    hi = np.where(any_nz, m.shape[1] - nz[:, ::-1].argmax(1), 0)
    return lo.astype(np.int32), hi.astype(np.int32)


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, out_size: int):
    """(R, C, r_lo, r_hi, c_lo, c_hi, rows, ny_max): the resize matrices,
    their rows' nonzero extents, the output rows a block takes and the most
    width-pass rows any block needs."""
    R, C = resize_crop_matrices(h, w, out_size, out_size)
    r_lo, r_hi = _extents(R)
    c_lo, c_hi = _extents(C)
    rows = ROWS
    while True:
        ny = max(int(r_hi[i:i + rows].max() - r_lo[i:i + rows].min())
                 for i in range(0, out_size, rows))
        if 12 * ny * out_size <= SMEM_TARGET or rows == 1:
            break
        rows //= 2
    if 12 * ny * out_size > MAX_SMEM:
        raise ValueError(f"preprocess_fused: {h}x{w} -> {out_size} needs {ny} input rows a "
                         f"block, more than shared memory holds")
    return R, C, r_lo, r_hi, c_lo, c_hi, rows, ny


@functools.lru_cache(maxsize=64)
def _device_plan(h: int, w: int, out_size: int, device: torch.device):
    R, C, *extents, rows, ny = plan(h, w, out_size)
    return ([torch.from_numpy(a).to(device) for a in (R, C, *extents)], rows, ny)


def preprocess_batch_fused(
    images: Union[np.ndarray, torch.Tensor],
    out_size: int = 224,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    emulate_uint8: bool = True,
) -> torch.Tensor:
    """K11: uint8 ``[B, H, W, 3]`` (or one ``[H, W, 3]`` image) on its device
    -> fp32 ``[B, out, out, 3]``: Resize(out) + CenterCrop(out) with PIL's
    bicubic weights and uint8 stores (``emulate_uint8``), then the CLIP
    normalize."""
    images = torch.as_tensor(images)
    if images.dim() == 3:
        images = images[None]
    if images.dtype != torch.uint8:
        raise ValueError(f"preprocess_fused: takes uint8 images, got {images.dtype}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"preprocess_fused: images of shape {tuple(images.shape)} are not "
                         f"[B, H, W, 3]")
    if _on_cpu(images, "preprocess_fused"):
        return preprocess_batch(images, out_size, mean, std, emulate_uint8=emulate_uint8)
    images = images.contiguous()
    B, h, w, _ = images.shape
    mats, rows, ny = _device_plan(h, w, out_size, images.device)
    m, s = (t.tolist() for t in normalize_constants(mean, std, "cpu"))
    out = torch.empty((B, out_size, out_size, 3), dtype=torch.float32, device=images.device)
    rc = _lib().plip_preprocess(images.data_ptr(), *(t.data_ptr() for t in mats),
                                out.data_ptr(), B, h, w, out_size, rows, ny, *m, *s,
                                int(emulate_uint8), images.device.index, _stream(images.device))
    if rc != 0:
        raise RuntimeError(f"preprocess_fused: CUDA kernel launch failed with error {rc}")
    LAUNCHES["preprocess_fused"] += 1
    return out
