"""Image preprocessing in one CUDA kernel: ``preprocess_batch_fused``.

The port of ``plip_tpu.ops.preprocess_pallas`` (K11, ``_kernel``): ``[B, H,
W, 3]`` images in, ``[B, out, out, 3]`` out, with the width pass, PIL's
uint8 store, the height pass, the store again and the CLIP normalize in one
launch (``csrc/preprocess.cu``). ``ops.preprocess.preprocess_batch(fused=
True)`` reaches it, as the JAX package's ``use_pallas=True`` reaches K11; the
default two-matmul path (``preprocess_batch``) is its plain version.

Images of any real or integer dtype are taken as the JAX wrapper takes them:
truncated to int32, then wrapped into 0..255 (``.to(int32).to(uint8)``; the
JAX wrapper's shift into int8 and the TPU kernel's shift back existed because
Mosaic had no u8 -> f32 cast). The kernel writes fp32 or bf16 (the fp32
values rounded once, as ``.to(torch.bfloat16)``); any other ``dtype`` is its
fp32 output cast.

``plan`` tiles a call on the host. Each row of the resize matrices becomes a
tap table: its first input column (or row) and its weights over a window
that holds the row's nonzero extent, the same fp32 values, so each sum runs
over the same terms as the dense row's. A block takes ``rows`` output rows
and reads the band of input rows their taps name, in chunks of
``chunk_rows`` (whole width-pass jobs: 4 rows, or 2 where the windows are
``WORD_TAPS`` wide or more and the kernel reads them as words); the width
pass's rows ``t`` are uint8 with ``emulate_uint8`` (integers 0..255 after
the store), fp32 without. ``rows`` is the most that keeps three blocks an
SM (else two, else one) in shared memory, as ``smem_bytes`` counts it; the
kernel refuses a plan whose count is not its own layout's.

On a CUDA tensor ``preprocess_batch_fused`` launches the kernel or raises;
on the CPU it is the plain version. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from . import _build
from ..models.config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from .attention import _DTYPE_CODES, _on_cpu, _stream
from .preprocess import normalize_constants, preprocess_batch
from .resize import resize_crop_matrices

LAUNCHES = {"preprocess_fused": 0}

# Shared memory a block may take for 3, 2 or 1 blocks an SM (228 KB an SM,
# 1 KB of it reserved a block; 227 KB a block at most), and the bytes of
# input rows a load chunk holds (at least one width-pass job's rows).
SMEM_TARGETS = (74 * 1024, 113 * 1024, 227 * 1024)
MAX_SMEM = SMEM_TARGETS[-1]
CHUNK_BYTES = 16 * 1024
# Windows of WORD_TAPS columns or more take the width pass by word loads
# (two rows a job), narrower ones by byte loads (four rows a job; the
# kernel's kWordRows and kByteRows).
WORD_TAPS = 8
JOB_ROWS = {True: 2, False: 4}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # img, c_start, c_w, r_start, r_w, band, out, B, H, W, n_out, taps_c,
    # cw_stride, taps_r, rows, ny_max, chunk_rows, words, smem, mean x3,
    # std x3, emulate, out dtype, device, stream
    "plip_preprocess": (_vp,) * 7 + (_int,) * 12 + (_float,) * 6 + (_int,) * 3 + (_vp,),
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


def tap_table(m: np.ndarray):
    """(start int32 [rows], weights fp32 [rows, taps]): each row of ``m``
    over [start, start + taps), taps the widest nonzero extent; the window
    holds the row's extent and ends inside the row."""
    lo, hi = _extents(m)
    taps = max(1, int((hi - lo).max()))
    start = np.minimum(lo, m.shape[1] - taps).astype(np.int32)
    return start, np.take_along_axis(m, start[:, None] + np.arange(taps), 1).astype(np.float32)


def _up16(v: int) -> int:
    return (v + 15) & ~15


def smem_bytes(n: int, cw_stride: int, rows: int, taps_r: int, ny: int, w: int,
               chunk_rows: int, emulate: bool, out_bytes: int) -> int:
    """A block's shared memory, as ``csrc/preprocess.cu``'s ``layout`` counts
    it (the kernel refuses any other count): the normalize's table, the tap
    tables (all columns, the block's rows), ``t`` and the ring of two
    chunks."""
    return (_up16(3 * 256 * out_bytes if emulate else 0) + _up16(4 * n)
            + _up16(4 * n * cw_stride) + _up16(4 * rows) + _up16(4 * rows * taps_r)
            + ny * _up16(3 * n * (1 if emulate else 4)) + 2 * _up16(chunk_rows * 3 * w + 32))


@dataclass(frozen=True)
class Plan:
    r_start: np.ndarray  # int32 [out]: output row i's first input row
    r_w: np.ndarray      # fp32 [out, taps_r]
    c_start: np.ndarray  # int32 [out]: output column j's first input column
    c_w: np.ndarray      # fp32 [out, cw_stride]: taps_c weights, zeros after
    taps_c: int
    rows: int            # output rows a block
    band: np.ndarray     # int32 [blocks, 2]: a block's first input row, its count
    ny: int              # the most input rows a block reads
    chunk_rows: int      # input rows a load chunk
    words: bool          # the width pass by word loads
    smem: int            # shared memory bytes a block


def _bands(r_start: np.ndarray, taps_r: int, rows: int) -> np.ndarray:
    """(y0, ny) of each block of ``rows`` output rows: the input rows of its
    rows' windows."""
    out = []
    for i0 in range(0, len(r_start), rows):
        starts = r_start[i0:i0 + rows]
        out.append((starts.min(), starts.max() + taps_r - starts.min()))
    return np.asarray(out, np.int32)


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, out_size: int, emulate: bool = True, out_bytes: int = 4) -> Plan:
    """The kernel's tiling of ``h x w -> out_size`` (module doc); raises
    ``ValueError`` where one output row's band does not fit a block."""
    R, C = resize_crop_matrices(h, w, out_size, out_size)
    c_start, c_w = tap_table(C)
    taps_c = c_w.shape[1]
    cw_stride = taps_c | 1  # odd: neighbouring columns' weights in other banks
    c_w = np.pad(c_w, ((0, 0), (0, cw_stride - taps_c)))
    words = taps_c >= WORD_TAPS
    job = JOB_ROWS[words]
    r_start, r_w = tap_table(R)
    taps_r = r_w.shape[1]
    options, seen = [], set()
    for blocks in range(1, out_size + 1):  # rows from out_size down to 1
        rows = -(-out_size // blocks)
        if rows in seen:
            continue
        seen.add(rows)
        band = _bands(r_start, taps_r, rows)
        ny = int(band[:, 1].max())
        chunk = min(ny, max(job, CHUNK_BYTES // (3 * w) // job * job))
        options.append((rows, band, ny, chunk, smem_bytes(
            out_size, cw_stride, rows, taps_r, ny, w, chunk, emulate, out_bytes)))
    for target in SMEM_TARGETS:
        fits = [o for o in options if o[4] <= target]
        if fits:
            break
    else:
        raise ValueError(f"preprocess_fused: {h}x{w} -> {out_size} needs {options[-1][4]} bytes "
                         f"of shared memory a block at one output row, more than the "
                         f"{MAX_SMEM} a block may take")
    rows, band, ny, chunk, smem = fits[0]
    return Plan(r_start, r_w, c_start, c_w, taps_c, rows, band, ny, chunk, words, smem)


@functools.lru_cache(maxsize=64)
def _device_plan(h: int, w: int, out_size: int, emulate: bool, out_bytes: int,
                 device: torch.device):
    p = plan(h, w, out_size, emulate, out_bytes)
    return p, [torch.from_numpy(a).to(device)
               for a in (p.c_start, p.c_w, p.r_start, p.r_w, p.band)]


def preprocess_batch_fused(
    images: Union[np.ndarray, torch.Tensor],
    out_size: int = 224,
    mean: tuple = CLIP_IMAGE_MEAN,
    std: tuple = CLIP_IMAGE_STD,
    emulate_uint8: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K11: ``[B, H, W, 3]`` (or one ``[H, W, 3]``) images on their device ->
    ``[B, out, out, 3]`` in ``dtype``: Resize(out) + CenterCrop(out) with
    PIL's bicubic weights and uint8 stores (``emulate_uint8``), then the CLIP
    normalize. Non-uint8 images are truncated and wrapped into 0..255 first,
    as the JAX wrapper takes them."""
    images = torch.as_tensor(images)
    if images.dim() == 3:
        images = images[None]
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"preprocess_fused: images of shape {tuple(images.shape)} are not "
                         f"[B, H, W, 3]")
    if images.dtype != torch.uint8:
        images = images.to(torch.int32).to(torch.uint8)  # the JAX wrapper's astype(int32)
    if _on_cpu(images, "preprocess_fused"):
        return preprocess_batch(images, out_size, mean, std, dtype, emulate_uint8=emulate_uint8)
    B, h, w, _ = images.shape
    out_dtype = dtype if dtype in _DTYPE_CODES else torch.float32
    p, tables = _device_plan(h, w, out_size, bool(emulate_uint8), out_dtype.itemsize,
                             images.device)
    images = images.contiguous()
    m, s = (t.tolist() for t in normalize_constants(mean, std, "cpu"))
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype, device=images.device)
    rc = _lib().plip_preprocess(
        images.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(), B, h, w, out_size,
        p.taps_c, p.c_w.shape[1], p.r_w.shape[1], p.rows, p.ny, p.chunk_rows, int(p.words),
        p.smem, *m, *s, int(emulate_uint8), _DTYPE_CODES[out_dtype], images.device.index,
        _stream(images.device))
    if rc != 0:
        raise RuntimeError(f"preprocess_fused: CUDA kernel launch failed with error {rc}")
    LAUNCHES["preprocess_fused"] += 1
    return out if out_dtype == dtype else out.to(dtype)
