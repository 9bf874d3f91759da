"""Native accelerator loader.

Builds `_tostore_native` (CPython extension, tostore_native.cpp: host
C++ for the codec and key-encoding hot loops, no device code) with g++ at
first use and caches the .so in the package's `_build/` directory beside
the CUDA kernels' libraries; the pure-Python implementations serve when no
compiler is available. Set TOSTORE_TPU_TORCH_NO_NATIVE=1 to force them
(used by equivalence tests). `which()` says which of the two is in use.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sysconfig
import threading

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "tostore_native.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SO = os.path.join(_BUILD, f"_tostore_native.{sysconfig.get_config_var('SOABI')}.so")

_mod = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    inc = sysconfig.get_paths()["include"]
    # compile beside the target, then rename: another process that builds
    # at the same moment never loads a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{inc}", _SRC, "-o", tmp,
    ]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get():
    """The native module, or None when unavailable/disabled."""
    global _mod, _tried
    if _mod is not None:
        return _mod
    if _tried or os.environ.get("TOSTORE_TPU_TORCH_NO_NATIVE"):
        return None
    with _lock:
        return _load()


def which() -> str:
    """"native" when the C++ helper is loaded, else "python"."""
    return "native" if get() is not None else "python"


def _load():
    global _mod, _tried
    if _mod is not None or _tried:
        return _mod
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        spec = importlib.util.spec_from_file_location("_tostore_native", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _mod = mod
    except Exception:
        _mod = None
    return _mod
