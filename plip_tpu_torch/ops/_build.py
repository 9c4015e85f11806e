"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
for Hopper (``sm_90a``), and the objects are linked into one shared library
with a plain C interface. The library's name carries a hash of the sources
(``*.cu`` and the ``*.cuh`` they include) and flags, so it is rebuilt only
when one of them changes; it lives in ``plip_tpu_torch/_build/`` (listed in
``.gitignore``), next to the compilers' log (``-Xptxas=-v``: registers,
shared memory and spills of every kernel). Building needs the CUDA toolkit:
``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on
``PATH``. ``COMPILES`` counts the builds of this process; the program spans
``kernels.build`` and ``kernels.load`` (``utils.profiling``) time the build and
the ``ctypes`` load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.profiling import span

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None
COMPILES = 0  # libraries this process compiled (0 when it found one built)


def _toolkit_binary(name: str) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", name)
    if os.path.exists(cand):
        return cand
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built or read")
    return found


def nvcc_path() -> str:
    return _toolkit_binary("nvcc")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libplip_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists."""
    lib = library_path()
    if lib.exists():
        return lib
    with span("kernels.build"):
        _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    """Compile and link ``csrc/*.cu`` into ``lib``."""
    global COMPILES
    COMPILES += 1
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    compiles = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in compiles:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
    tmp = lib.with_name(f"{tag}.so.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in compiles)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}")
    for _, obj, _ in compiles:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file


def sass_command() -> list:
    """The command that prints the SASS of the built library."""
    return [_toolkit_binary("cuobjdump"), "--dump-sass", str(build())]


def sass_counts(opcode: str = "HGMMA", sass: str | None = None) -> dict:
    """``{mangled kernel name: number of `opcode` instructions}`` in the SASS
    of the built library (``sass``: the output of ``sass_command``, which is
    run when it is not given), for every kernel in it. ``HGMMA`` is the SASS
    of ``wgmma.mma_async``."""
    if sass is None:
        sass = subprocess.run(sass_command(), capture_output=True, text=True,
                              check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line[len("Function : "):].strip()
            counts[name] = 0
        elif name is not None and f" {opcode}." in line:
            counts[name] += 1
    return counts


def load() -> ctypes.CDLL:
    """The kernel library, built if needed. Raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            with span("kernels.load"):
                _lib = ctypes.CDLL(str(path))
        return _lib


def bind(signatures) -> ctypes.CDLL:
    """The library with ``argtypes`` set for each ``{name: argtypes}`` entry
    point (each returns an int error code)."""
    lib = load()
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
