"""zstd through ``ctypes`` and the system's ``libzstd.so.1``: the codec of
ArrayRecord's compressed chunks (``data/array_record.py``) and of Orbax's
OCDBT files and zarr chunks (``orbax_checkpoint.py``).

The library is loaded at the first call, by its soname, from the dynamic
loader's path.  Frames are written as riegeli writes them for the JAX
package's default options (``zstd:3,window_log:20``): level 3, a 1 MiB
window, the content size in the frame header, no checksum.  Without
``libzstd.so.1`` every call raises ``OSError`` naming it: there is no
other codec and no quiet switch to uncompressed chunks.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["LIBRARY_NAME", "compress", "decompress", "library_path",
           "version"]

LIBRARY_NAME = "libzstd.so.1"
LEVEL = 3
WINDOW_LOG = 20

# ZSTD_cParameter values (zstd.h, stable since 1.4.0)
_C_COMPRESSION_LEVEL = 100
_C_WINDOW_LOG = 101
_C_CONTENT_SIZE_FLAG = 200
_C_CHECKSUM_FLAG = 201
_CONTENT_SIZE_UNKNOWN = 2**64 - 1
_CONTENT_SIZE_ERROR = 2**64 - 2

_SESSION_ONLY = 1      # ZSTD_reset_session_only

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# one compression and one decompression context a thread
_contexts = threading.local()


class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` and ``ZSTD_outBuffer``: the same three fields."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, size_t = ctypes.c_void_p, ctypes.c_size_t
    lib.ZSTD_versionNumber.argtypes = []
    lib.ZSTD_versionNumber.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_compressBound.argtypes = [size_t]
    lib.ZSTD_compressBound.restype = size_t
    lib.ZSTD_createCCtx.argtypes = []
    lib.ZSTD_createCCtx.restype = p
    lib.ZSTD_freeCCtx.argtypes = [p]
    lib.ZSTD_freeCCtx.restype = size_t
    lib.ZSTD_CCtx_setParameter.argtypes = [p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = size_t
    lib.ZSTD_compress2.argtypes = [p, p, size_t, p, size_t]
    lib.ZSTD_compress2.restype = size_t
    lib.ZSTD_createDCtx.argtypes = []
    lib.ZSTD_createDCtx.restype = p
    lib.ZSTD_freeDCtx.argtypes = [p]
    lib.ZSTD_freeDCtx.restype = size_t
    lib.ZSTD_decompressDCtx.argtypes = [p, p, size_t, p, size_t]
    lib.ZSTD_decompressDCtx.restype = size_t
    lib.ZSTD_getFrameContentSize.argtypes = [p, size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_DStreamOutSize.argtypes = []
    lib.ZSTD_DStreamOutSize.restype = size_t
    lib.ZSTD_decompressStream.argtypes = [
        p, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]
    lib.ZSTD_decompressStream.restype = size_t
    lib.ZSTD_DCtx_reset.argtypes = [p, ctypes.c_int]
    lib.ZSTD_DCtx_reset.restype = size_t
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY_NAME)
            except OSError as e:
                raise OSError(
                    f"{LIBRARY_NAME} cannot be loaded ({e}): ArrayRecord's "
                    "zstd chunks are read and written through it") from e
            _lib = _bind(lib)
        return _lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(
            f"zstd {what} failed: {lib.ZSTD_getErrorName(code).decode()}")
    return code


class _Context:
    """A zstd context owned by one thread, freed with it."""

    def __init__(self, lib, create, free):
        self.lib, self.ptr, self._free = lib, create(), free
        if not self.ptr:
            raise MemoryError("zstd context allocation failed")

    def __del__(self):
        self._free(self.ptr)


def _cctx(lib: ctypes.CDLL) -> int:
    ctx = getattr(_contexts, "cctx", None)
    if ctx is None:
        ctx = _Context(lib, lib.ZSTD_createCCtx, lib.ZSTD_freeCCtx)
        for param, value in ((_C_COMPRESSION_LEVEL, LEVEL),
                             (_C_WINDOW_LOG, WINDOW_LOG),
                             (_C_CONTENT_SIZE_FLAG, 1),
                             (_C_CHECKSUM_FLAG, 0)):
            _check(lib, lib.ZSTD_CCtx_setParameter(ctx.ptr, param, value),
                   "setParameter")
        _contexts.cctx = ctx
    return ctx.ptr


def _dctx(lib: ctypes.CDLL) -> int:
    ctx = getattr(_contexts, "dctx", None)
    if ctx is None:
        ctx = _contexts.dctx = _Context(lib, lib.ZSTD_createDCtx,
                                        lib.ZSTD_freeDCtx)
    return ctx.ptr


def compress(data) -> bytes:
    """One zstd frame of ``data``, any contiguous buffer (level 3, window
    log 20, content size set, no checksum)."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    cap = lib.ZSTD_compressBound(src.size)
    out = np.empty(cap, np.uint8)
    n = _check(lib, lib.ZSTD_compress2(_cctx(lib), out.ctypes.data, cap,
                                       src.ctypes.data, src.size),
               "compression")
    return out[:n].tobytes()


def decompress(frame, size: int | None = None) -> np.ndarray:
    """The ``size`` bytes that the zstd ``frame`` (any contiguous buffer)
    holds, as a uint8 array; ``ValueError`` if the frame is corrupt or
    holds another size.  With ``size`` None the frame's own content size
    is taken, or, where the frame does not state one (a streamed frame),
    whatever it holds."""
    lib = _load()
    src = np.frombuffer(frame, np.uint8)
    stated = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if stated == _CONTENT_SIZE_ERROR:
        raise ValueError("not a zstd frame")
    if size is None:
        if stated == _CONTENT_SIZE_UNKNOWN:
            return _decompress_stream(lib, src)
        size = int(stated)
    if stated != _CONTENT_SIZE_UNKNOWN and stated != size:
        raise ValueError(
            f"zstd frame holds {stated} bytes where {size} are expected")
    out = np.empty(size, np.uint8)
    n = _check(lib, lib.ZSTD_decompressDCtx(_dctx(lib), out.ctypes.data,
                                            size, src.ctypes.data, src.size),
               "decompression")
    if n != size:
        raise ValueError(
            f"zstd frame holds {n} bytes where {size} are expected")
    return out


def _decompress_stream(lib: ctypes.CDLL, src: np.ndarray) -> np.ndarray:
    """One whole frame of unstated size, decoded in steps of the
    library's recommended output size."""
    dctx = _dctx(lib)
    _check(lib, lib.ZSTD_DCtx_reset(dctx, _SESSION_ONLY), "reset")
    inb = _Buffer(src.ctypes.data, src.size, 0)
    step = int(lib.ZSTD_DStreamOutSize())
    parts = []
    while True:
        out = np.empty(step, np.uint8)
        outb = _Buffer(out.ctypes.data, step, 0)
        left = _check(lib, lib.ZSTD_decompressStream(
            dctx, ctypes.byref(outb), ctypes.byref(inb)), "decompression")
        parts.append(out[:outb.pos])
        if left == 0:
            break
        if inb.pos == inb.size and outb.pos < step:
            raise ValueError("zstd frame is truncated")
    if inb.pos != inb.size:
        raise ValueError(f"{inb.size - inb.pos} bytes after the zstd frame")
    return np.concatenate(parts)


def version() -> str:
    """The loaded library's version, as ``major.minor.release``."""
    v = int(_load().ZSTD_versionNumber())
    return f"{v // 10000}.{v // 100 % 100}.{v % 100}"


def library_path() -> str:
    """The file the dynamic loader mapped for ``libzstd.so.1``."""
    _load()
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "libzstd" in path:
                return path
    return LIBRARY_NAME
