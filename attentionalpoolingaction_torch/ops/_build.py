"""Build-at-first-use loader for the CUDA kernels in ``csrc/``.

``nvcc`` compiles ``csrc/attn_pool.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which is loaded with ``ctypes``.  The
library lands in ``attentionalpoolingaction_torch/_build/`` under a name
that carries a hash of the source and the flags, so an edited source is
never served by a stale build.  Nothing is compiled when a module is
imported: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "attn_pool.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # what nvcc printed (registers, shared memory, spills);
                # kept beside the library as <name>.log and read back


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the attentional pooling "
            "kernels are built from csrc/ at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libattn_pool-{digest[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of this exact source exists."""
    global build_log
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
    # the log first: a loader that finds the library finds its log too
    log_tmp = log.with_suffix(f".{os.getpid()}.logtmp")
    log_tmp.write_text(build_log)
    os.replace(log_tmp, log)
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib.apa_saliency_summary.argtypes = [p, i, p, p, p, p, i, i, i, i,
                                         i, i, i, ll, p]
    lib.apa_saliency_summary.restype = i
    lib.apa_project_logits.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                       i, i, i, i, ll, p]
    lib.apa_project_logits.restype = i
    lib.apa_last_active_clusters.argtypes = []
    lib.apa_last_active_clusters.restype = i
    lib.apa_error_string.argtypes = [i]
    lib.apa_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def loaded() -> bool:
    return _lib is not None
