"""Build and load the port's CUDA kernels (`tostore_tpu_torch/csrc/*.cu`).

At first use, `library()` compiles each source under `csrc/` with its own
nvcc process, all started together, into one shared library per source
with a plain C interface, for `sm_90a` (Hopper), and loads them with
ctypes. The libraries go to `tostore_tpu_torch/_build/` under names keyed
by a hash of the source (and the shared headers and flags), so an edited
kernel is rebuilt and an unchanged one is loaded as it is. A missing nvcc
or a failed build raises: no kernel has a silent substitute on the card.

Nothing here runs at import time; importing this module needs no CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

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
_L = ctypes.c_longlong
# C signatures of the entry points in csrc/: pointers and the stream are
# c_void_p
_SIGNATURES = {
    # lane_scan_acc.cu, lane_scan_emit.cu (K1, K2: bf16 and int8 corpora)
    "lane_topk_acc": [_P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_emit": [_P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # lane_scan_group.cu (K5, K6: bf16 and int8 corpora)
    "lane_topk_group": [_P, _P, _I, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_group_pipe": [_P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # lane_topk.cu (K1, K2, K5, K6 for f32 corpora)
    "lane_topk_acc_f32": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_emit_f32": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_group_f32": [_P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    "lane_topk_group_pipe_f32": [_P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P],
    # ivf_probe.cu (K3, K4)
    "ivf_bucket_probe": [_P, _P, _I, _L, _L, _I, _I, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                         _P],
    "ivf_adc": [_P, _L, _L, _P, _I, _L, _L, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                _P, _P],
    "ivf_group_pairs": [_P, _I, _L, _L, _I, _I, _I, _P, _P, _P],
    # select_topk.cu (the final selection of every search route)
    "select_topk": [_P, _L, _I, _I, _I, _I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None
# what the last build printed (nvcc -Xptxas -v: registers, shared memory,
# spills per kernel) and how long it took (wall clock, all sources
# together); empty when every library was cached
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


def _build() -> list[Path]:
    """One library per .cu source, the missing ones compiled in parallel."""
    global build_log, build_seconds
    srcs = _sources()
    shared = b"".join(p.name.encode() + p.read_bytes() for p in srcs if p.suffix != ".cu")
    libs, jobs = [], []
    for cu in (p for p in srcs if p.suffix == ".cu"):
        digest = hashlib.sha256(cu.read_bytes() + shared + " ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"lib{cu.stem}_{digest.hexdigest()[:16]}.so"
        libs.append(so)
        if not so.exists():
            jobs.append((cu, so))
    if not jobs:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for cu, so in jobs:
            # build to a temporary name, then rename: a concurrent loader
            # never sees a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(cu)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((cu, so, tmp, proc))
        logs, failed = [], []
        for cu, so, tmp, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {cu.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{cu.name} ({proc.returncode})")
                os.unlink(tmp)
            else:
                os.replace(tmp, so)
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    return libs


def library() -> SimpleNamespace:
    """The kernels' C entry points (`_SIGNATURES`), built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = [ctypes.CDLL(str(so)) for so in _build()]
            fns = {}
            for name, argtypes in _SIGNATURES.items():
                owners = [lib for lib in loaded if hasattr(lib, name)]
                if len(owners) != 1:
                    raise RuntimeError(f"{name}: found in {len(owners)} kernel libraries")
                fn = getattr(owners[0], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            _lib = SimpleNamespace(**fns)
        return _lib


_count_lock = threading.Lock()
_recorder = threading.local()


def count(launches: dict, name: str, n: int = 1):
    """Add to a wrapper's launch counter. `d[k] += n` is a read and a
    write: searches from several threads (the engine releases its lock
    across a search) would lose counts without the lock. Inside
    `recording()` the count goes to the recording instead."""
    rec = getattr(_recorder, "launches", None)
    if rec is not None:
        rec.append((launches, name, n))
        return
    with _count_lock:
        launches[name] += n


@contextlib.contextmanager
def recording():
    """This thread's launch counts, as (counters, name, n), go to the
    yielded list instead of the counters: a CUDA graph's capture launches
    nothing, and each replay adds what it recorded (`add`)."""
    rec = []
    _recorder.launches = rec
    try:
        yield rec
    finally:
        _recorder.launches = None


def add(recorded):
    """Add recorded launch counts to their counters."""
    with _count_lock:
        for launches, name, n in recorded:
            launches[name] += n


def check(name: str, err: int):
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
