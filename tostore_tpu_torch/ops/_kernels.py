"""Build and load the port's CUDA kernels (`tostore_tpu_torch/csrc/*.cu`).

At first use, `library()` compiles every source under `csrc/` with nvcc
into one shared library with a plain C interface, for `sm_90a` (Hopper),
and loads it with ctypes. The library goes to `tostore_tpu_torch/_build/`
under a name keyed by a hash of the sources, so an edited kernel is
rebuilt and an unchanged one is loaded as it is. A missing nvcc or a
failed build raises: no kernel has a silent substitute on the card.

Nothing here runs at import time; importing this module needs no CUDA.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures (csrc/lane_topk.cu): pointers and the stream are c_void_p
_SIGNATURES = {
    "lane_topk_acc": [_P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_emit": [_P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build printed (nvcc -Xptxas -v: registers, shared memory,
# spills per kernel) and how long it took; empty when the .so was cached
build_log = ""
build_seconds = 0.0


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh", ".h"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _build() -> Path:
    global build_log, build_seconds
    srcs = _sources()
    digest = hashlib.sha256()
    for p in srcs:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libtostore_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in srcs if p.suffix == ".cu"]
    # build to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
