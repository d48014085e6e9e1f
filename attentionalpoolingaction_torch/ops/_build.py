"""Build-at-first-use loader for the native sources in ``csrc/``.

Each source compiles into a shared library with a plain C interface,
which is loaded with ``ctypes``: ``csrc/attn_pool.cu`` (the attentional
pooling kernels), ``csrc/attn_pool_backward.cu`` (the head's backward; the
two share ``csrc/attn_pool_common.cuh``) and ``csrc/jpeg_decode.cu`` (the
nvJPEG binding and the colour kernel) with ``nvcc`` for ``sm_90a``,
``csrc/tfrecord_index.cc`` (the indexed record reader) and
``csrc/array_record.cc`` (the ArrayRecord container) with the host's C++
compiler.  A library lands in ``attentionalpoolingaction_torch/_build/``
under a name that carries a hash of its source, the headers it includes
and its flags, so an edited source is never served by a stale
build.  Nothing is compiled when a module is imported: the first call that
needs a library builds it, and two builds may run at once (each in its own
thread, or its own process).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def cuda_home() -> Path:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return Path(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA sources are "
            "built from csrc/ at first use")
    return Path(found).resolve().parent.parent


def nvcc() -> str:
    return str(cuda_home() / "bin" / "nvcc")


def cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX): csrc/"
                       "tfrecord_index.cc and csrc/array_record.cc are "
                       "built at first use")


class NativeLibrary:
    """One source of ``csrc/`` and the library built from it.

    ``compiler`` gives the compiler's path; ``flags`` are hashed with the
    source and the ``headers`` it includes; ``link_flags(compiler)`` adds
    flags that depend on where the toolkit lies (library paths), which the
    hash does not need; ``bind`` sets the ``argtypes`` and ``restype`` of
    every entry point."""

    def __init__(self, name: str, source: Path, *,
                 compiler: Callable[[], str], flags: tuple[str, ...],
                 bind: Callable[[ctypes.CDLL], ctypes.CDLL],
                 link_flags: Callable[[str], tuple[str, ...]] = lambda c: (),
                 headers: tuple[Path, ...] = ()):
        self.name, self.source, self.flags = name, Path(source), flags
        self.headers = tuple(Path(h) for h in headers)
        self._compiler, self._bind, self._link_flags = \
            compiler, bind, link_flags
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        # what the compiler printed (for nvcc -Xptxas -v: registers, shared
        # memory, spills); kept beside the library as <name>.log
        self.build_log = ""

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in (self.source, *self.headers))
            + " ".join(self.flags).encode()).hexdigest()
        return BUILD_DIR / f"lib{self.name}-{digest[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a build of this exact source exists."""
        out = self.library_path()
        log = out.with_suffix(".log")
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.{threading.get_ident()}"
        tmp = out.with_suffix(f".{tag}.tmp")
        compiler = self._compiler()
        proc = subprocess.run(
            [compiler, *self.flags, "-o", str(tmp), str(self.source),
             *self._link_flags(compiler)],
            capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{Path(compiler).name} failed on {self.source}:\n"
                f"{self.build_log}")
        # the log first: a loader that finds the library finds its log too
        log_tmp = log.with_suffix(f".{tag}.logtmp")
        log_tmp.write_text(self.build_log)
        os.replace(log_tmp, log)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        return out

    def load(self) -> ctypes.CDLL:
        """The library, built on the first call."""
        with self._lock:
            if self._lib is None:
                self._lib = self._bind(ctypes.CDLL(str(self.build())))
            return self._lib

    def loaded(self) -> bool:
        return self._lib is not None


def _bind_attn_pool(lib: ctypes.CDLL) -> ctypes.CDLL:
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


def _bind_attn_pool_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.apb_pool_backward.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i,
                                      i, i, i, i, i, ctypes.c_longlong, p]
    lib.apb_pool_backward.restype = i
    lib.apb_last_active_clusters.argtypes = []
    lib.apb_last_active_clusters.restype = i
    lib.apb_error_string.argtypes = [i]
    lib.apb_error_string.restype = ctypes.c_char_p
    return lib


_COMMON = (CSRC / "attn_pool_common.cuh",)
ATTN_POOL = NativeLibrary("attn_pool", CSRC / "attn_pool.cu", compiler=nvcc,
                          flags=NVCC_FLAGS, bind=_bind_attn_pool,
                          headers=_COMMON)
ATTN_POOL_BACKWARD = NativeLibrary(
    "attn_pool_backward", CSRC / "attn_pool_backward.cu", compiler=nvcc,
    flags=NVCC_FLAGS, bind=_bind_attn_pool_backward, headers=_COMMON)

