"""Build the port's CUDA kernels with nvcc at first use; load them with ctypes.

The source is `csrc/tree_kernels.cu`, a plain C interface (no PyTorch
headers), so one nvcc call takes seconds. The shared library goes into
`transmogrifai_tpu_torch/_build/` (listed in .gitignore) under a name keyed
by the source and flags, so an edited source never loads a stale build.
Nothing is built at import: `library()` builds on its first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..utils import tracing

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tree_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None
build_log = ""   # nvcc's stderr of the last build (ptxas register/smem use)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "tk_hist": (_P, _I, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _L, _I, _P),
    "tk_route_hist": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _L, _I, _P),
    "tk_route": (_P, _I, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                 _I, _P),
    "tk_lookup": (_P, _P, _P, _I, _L, _I, _I, _I, _P),
}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under $CUDA_HOME or /usr/local/cuda.
    Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "transmogrifai_tpu_torch need the CUDA toolkit")


def _compile() -> Path:
    """The built library, built now unless this source and these flags were
    built before. The tracker of utils/tracing counts a build as a compile
    and a load of an earlier build as a cache hit."""
    global build_log
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"tree_kernels-{digest}.so"
    if out.exists():
        tracing.tracker.note_cache_hit("tree_kernels")
        return out
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    build_log = res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    tracing.tracker.note_build("tree_kernels", time.perf_counter() - t0)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.tk_error_string.argtypes = [ctypes.c_int]
            lib.tk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.tk_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
