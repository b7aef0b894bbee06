"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that :func:`load` opens with ``ctypes``.  A
build happens at first use, into ``build/flyp_tpu_torch_kernels/`` beside
the package, under a name keyed by the source and flags, so an edited
source rebuilds and concurrent processes never load a half-written file.
Within a process, a lock per source makes threads that reach a kernel's
first use together wait for one compile and share one loaded library;
different sources still build at once (:func:`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "flyp_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Compiler output of each build this process ran (ptxas register/smem report).
build_logs: dict = {}

_locks_guard = threading.Lock()
_locks: dict = {}  # source name -> the RLock that serialises its build and load
_loaded: dict = {}  # source name -> its CDLL


def _lock(name: str) -> threading.RLock:
    with _locks_guard:
        return _locks.setdefault(name, threading.RLock())


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    text = b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists."""
    with _lock(name):
        lib = library_path(name)
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
        return lib


def build_all() -> dict:
    """Build every ``csrc/*.cu`` at once, one ``nvcc`` per source."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use; one
    object per process, whatever the number of threads asking."""
    with _lock(name):
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.flyp_error_string.argtypes = [ctypes.c_int]
            lib.flyp_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check_out(what: str, out, shape, dtype, device) -> None:
    """Raise ``ValueError`` unless ``out`` is None or a contiguous ``dtype``
    tensor of ``shape`` on ``device``: a kernel writes into it."""
    if out is not None and (tuple(out.shape) != tuple(shape) or out.dtype != dtype or out.device != device
                            or not out.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} {list(shape)} on {device}")


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise with CUDA's message when a C entry point returned an error."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} ({lib.flyp_error_string(code).decode()})")
