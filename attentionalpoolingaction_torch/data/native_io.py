"""ctypes bindings for the indexed TFRecord reader
(``csrc/tfrecord_index.cc``) and a random-access data source over it: the
port's copy of the JAX package's ``data/native_io.py``.

Raw TFRecords are a stream format; the train pipeline's global shuffle
needs O(1) record access.  ``build_index`` does one native scan producing
a binary (offset, length) index; ``IndexedTFRecordFile`` then serves
``reader[i] -> bytes`` via pread: thread-safe and picklable (the handle
reopens lazily after unpickling).  The index is ``<file>.idx`` beside the
record file, byte for byte the JAX package's format, so either package
reads the other's.

The library is built at first use with the host's C++ compiler into the
package's ``_build/`` (``ops/_build.py``).  ``make_source`` opens
ArrayRecord files (``*.array_record``, ``*.arrayrecord``) with the port's
own codec (``data/array_record.py``), as the JAX package opens them with
Grain's ``ArrayRecordDataSource``.
"""

from __future__ import annotations

import bisect
import ctypes
import glob
import os

from attentionalpoolingaction_torch.data.array_record import ArrayRecordFile
from attentionalpoolingaction_torch.ops import _build

__all__ = ["ArrayRecordDataSource", "IndexedTFRecordFile",
           "TFRecordDataSource", "build_index", "make_source",
           "masked_crc32c"]

_ARRAY_RECORD = (".array_record", ".arrayrecord")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tfr_build_index.restype = i64
    lib.tfr_build_index.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.tfr_open.restype = p
    lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.tfr_count.restype = i64
    lib.tfr_count.argtypes = [p]
    lib.tfr_record_length.restype = i64
    lib.tfr_record_length.argtypes = [p, i64]
    lib.tfr_read.restype = i64
    lib.tfr_read.argtypes = [p, i64, ctypes.c_char_p, i64]
    lib.tfr_close.argtypes = [p]
    lib.tfr_close.restype = None
    lib.tfr_masked_crc32c.restype = ctypes.c_uint32
    lib.tfr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    return lib


LIBRARY = _build.NativeLibrary(
    "tfrecord_index", _build.CSRC / "tfrecord_index.cc", compiler=_build.cxx,
    flags=_build.CXX_FLAGS, bind=_bind)


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC32C of ``data`` (native)."""
    return int(LIBRARY.load().tfr_masked_crc32c(bytes(data), len(data)))


def build_index(tfrecord_path: str, index_path: str | None = None,
                *, verify_crc: bool = True) -> int:
    """Index a TFRecord file (native sequential scan).  Returns the record
    count.  Default index path: ``<tfrecord_path>.idx``."""
    index_path = index_path or tfrecord_path + ".idx"
    n = LIBRARY.load().tfr_build_index(
        os.fsencode(tfrecord_path), os.fsencode(index_path),
        1 if verify_crc else 0)
    if n == -1:
        raise OSError(f"cannot open {tfrecord_path} or {index_path}")
    if n == -2:
        raise ValueError(f"corrupt TFRecord framing/CRC in {tfrecord_path}")
    return int(n)


class IndexedTFRecordFile:
    """Random access to one TFRecord file: ``reader[i] -> bytes``.

    Picklable (reopens lazily after unpickling).  Builds the index on first
    use when missing."""

    def __init__(self, tfrecord_path: str, index_path: str | None = None,
                 *, verify_crc: bool = False):
        self.tfrecord_path = tfrecord_path
        self.index_path = index_path or tfrecord_path + ".idx"
        self.verify_crc = verify_crc
        self._handle = None
        self._count = None
        self._ensure_open()

    def _ensure_open(self):
        if self._handle is not None:
            return
        lib = LIBRARY.load()
        if not os.path.exists(self.index_path):
            build_index(self.tfrecord_path, self.index_path)
        h = lib.tfr_open(os.fsencode(self.tfrecord_path),
                         os.fsencode(self.index_path),
                         1 if self.verify_crc else 0)
        if not h:
            raise OSError(
                f"cannot open {self.tfrecord_path} / {self.index_path}")
        self._handle = h
        self._count = int(lib.tfr_count(h))

    def __len__(self) -> int:
        self._ensure_open()
        return self._count

    def __getitem__(self, i: int) -> bytes:
        self._ensure_open()
        if i < 0:
            i += self._count
        lib = LIBRARY.load()
        length = lib.tfr_record_length(self._handle, i)
        if length < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(max(length, 1))
        got = lib.tfr_read(self._handle, i, buf, length)
        if got == -3:
            raise ValueError(f"CRC mismatch at record {i}")
        if got < 0 or got != length:
            raise OSError(f"read failed at record {i}: {got}")
        return buf.raw[:length]

    def close(self):
        if self._handle is not None:
            LIBRARY.load().tfr_close(self._handle)
            self._handle = None

    def __getstate__(self):
        return {"tfrecord_path": self.tfrecord_path,
                "index_path": self.index_path,
                "verify_crc": self.verify_crc}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._handle = None
        self._count = None


def _paths(pattern) -> list[str]:
    if isinstance(pattern, str):
        return sorted(glob.glob(pattern)) or [pattern]
    return list(pattern)


def make_source(pattern, *, verify_crc: bool = False):
    """Random-access source for a file pattern (a glob, or a list of
    paths), by format: ArrayRecord files (``*.array_record``,
    ``*.arrayrecord``) give an :class:`ArrayRecordDataSource`, anything
    else indexed TFRecords.  Both give serialized ``tf.train.Example``
    bytes; a mix of the two raises ``ValueError``.  ``verify_crc`` checks
    each record's checksum (ArrayRecord: each chunk's data hash)."""
    paths = _paths(pattern)
    if any(p.endswith(_ARRAY_RECORD) for p in paths):
        if not all(p.endswith(_ARRAY_RECORD) for p in paths):
            raise ValueError(f"mixed record formats in {paths}")
        return ArrayRecordDataSource(paths, verify_hash=verify_crc)
    return TFRecordDataSource(paths, verify_crc=verify_crc)


class _Concatenation:
    """Global indexing into the concatenation of per-file records."""

    def __init__(self, files):
        self._files = files
        self._offsets = []
        total = 0
        for f in self._files:
            self._offsets.append(total)
            total += len(f)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, i: int) -> bytes:
        if i < 0:
            i += self._total
        if not 0 <= i < self._total:
            raise IndexError(i)
        fi = bisect.bisect_right(self._offsets, i) - 1
        return self._files[fi][i - self._offsets[fi]]


class TFRecordDataSource(_Concatenation):
    """Random-access source over sharded TFRecord files."""

    def __init__(self, paths, *, verify_crc: bool = False):
        super().__init__([IndexedTFRecordFile(p, verify_crc=verify_crc)
                          for p in _paths(paths)])

    @property
    def files(self):
        return list(self._files)


class ArrayRecordDataSource(_Concatenation):
    """Random-access source over sharded ArrayRecord files.  It has no
    ``files``: the video index scans it directly
    (``grain_pipeline.build_video_index``), as the JAX package scans
    Grain's source."""

    def __init__(self, paths, *, verify_hash: bool = False):
        super().__init__([ArrayRecordFile(p, verify_hash=verify_hash)
                          for p in _paths(paths)])
