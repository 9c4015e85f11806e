"""ctypes bindings for the host JPEG decode pool (``decode.cpp``): the port's
own copy of ``plip_tpu.native``, which it does not import.

Builds the shared library on first use with g++ into ``plip_tpu_torch/_build/``
(listed in ``.gitignore``); where the toolchain or libjpeg is missing,
``available()`` is False and callers decode with PIL, as the JAX package's
callers do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "decode.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libptn_decode.so")
_lock = threading.Lock()
_lib = None
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
        "-o", tmp, "-ljpeg", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        return getattr(e, "stderr", str(e)) or str(e)
    os.replace(tmp, _LIB)  # atomic: a concurrent loader never sees half a file
    return None


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build_error = _build()
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(_LIB)
        lib.ptn_decode_file.restype = ctypes.c_int
        lib.ptn_decode_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.ptn_decode_batch_fixed.restype = ctypes.c_int
        lib.ptn_decode_batch_fixed.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def decode_jpeg(path: str, scale_shorter: int = 0) -> Optional[np.ndarray]:
    """Decode one JPEG to HWC uint8 RGB; None on failure (caller falls back).

    scale_shorter > 0 enables libjpeg DCT scaling: the cheapest M/8 scale whose
    shorter side stays >= scale_shorter.
    """
    lib = load()
    if lib is None:
        return None
    cap = 1 << 26
    buf = np.empty(cap, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.ptn_decode_file(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(w), ctypes.byref(h), scale_shorter,
    )
    if rc == -3:  # larger than 64MB RGB; retry with 256MB
        cap = 1 << 28
        buf = np.empty(cap, np.uint8)
        rc = lib.ptn_decode_file(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            cap, ctypes.byref(w), ctypes.byref(h), scale_shorter,
        )
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_batch_fixed(
    paths: List[str], shorter: int = 224, crop: int = 224, threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode+resize+crop a batch into [n, crop, crop, 3] uint8.

    Returns (batch, status). status[i] == 0: bit-exact (the source was
    already crop x crop, nothing was resampled); status[i] == 1: decoded OK
    but RESAMPLED (DCT scaling / host bilinear ran — approximate vs the
    PIL-bicubic contract, so fidelity-sensitive callers should re-decode the
    slot exactly); status[i] < 0: failed (slot zero-filled, re-decode via
    PIL).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native decode library unavailable")
    n = len(paths)
    out = np.empty((n, crop, crop, 3), np.uint8)
    status = np.empty(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ptn_decode_batch_fixed(
        c_paths, n, shorter, crop,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), threads,
    )
    return out, status
