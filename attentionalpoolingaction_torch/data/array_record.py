"""ArrayRecord files without ``array_record``: the container that the JAX
package writes with ``ArrayRecordWriter(path, "group_size:1")`` and reads
with Grain's ``ArrayRecordDataSource``, read and written by the port's own
codec (the card's machine has neither package).

An ArrayRecord file is a riegeli file.  The block and chunk layer (64 KiB
blocks, chunk and block headers, their HighwayHash-64 hashes, ``pread``
access) is ``csrc/array_record.cc``, built at first use with the host's
C++ compiler (``ops/_build.py``).  Here is what the chunks hold:

  1. a signature chunk ``'s'`` at offset 0;
  2. one simple chunk ``'r'`` a group of ``group_size`` records: a
     compression byte (``'z'`` zstd, or 0 for none), the varint size of the
     sizes section, the sizes section (the record lengths as varints) and
     the values (the records, end to end); compressed, each section is the
     varint of its decompressed size and a zstd frame (``data/zstd.py``);
  3. the footer, a simple chunk of one ``RiegeliFooterMetadata`` proto
     (version 1, the counts of chunks and records, the writer's options
     string) and one ``ArrayRecordFooter`` proto a chunk (its offset,
     decoded size and record count);
  4. padding to a block boundary, then a chunk of three copies of the
     postscript proto (the footer's offset and a magic number), then
     padding to the end of that block.

:func:`write_array_record_file` writes the JAX package's default options
(``group_size:N,transpose:false,pad_to_block_boundary:false,zstd:3,
window_log:20,max_parallelism:1``); :class:`ArrayRecordFile` reads any
group size, zstd or uncompressed chunks.  Transposed chunks
(``transpose:true``), brotli and snappy raise ``NotImplementedError``.
"""

from __future__ import annotations

import bisect
import ctypes
import os
import threading
import weakref

import numpy as np

from attentionalpoolingaction_torch.data import zstd
from attentionalpoolingaction_torch.ops import _build
from attentionalpoolingaction_torch.tf_checkpoint import (
    _fields,
    _varint as _read_varint,
)

__all__ = ["ArrayRecordFile", "LIBRARY", "highway_hash", "writer_options",
           "write_array_record_file"]

BLOCK_SIZE = 1 << 16
# RiegeliPostscript.magic
_MAGIC = 0x71930E704FDAE05E
_FOOTER_VERSION = 1
# chunk types
_SIGNATURE, _SIMPLE, _TRANSPOSED = b"s"[0], b"r"[0], b"t"[0]
# compression types of a simple chunk
_NONE, _ZSTD = 0, b"z"[0]
_UNSUPPORTED_COMPRESSION = {b"b"[0]: "brotli", b"s"[0]: "snappy"}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, u64, i64, i = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                      ctypes.c_int)
    lib.ar_highway_hash.argtypes = [ctypes.c_char_p, u64]
    lib.ar_highway_hash.restype = u64
    lib.ar_error_string.argtypes = [i]
    lib.ar_error_string.restype = ctypes.c_char_p
    lib.ar_open.argtypes = [ctypes.c_char_p]
    lib.ar_open.restype = p
    lib.ar_size.argtypes = [p]
    lib.ar_size.restype = i64
    lib.ar_chunk_header.argtypes = [p, u64, ctypes.POINTER(u64)]
    lib.ar_chunk_header.restype = i
    lib.ar_chunk_data.argtypes = [p, u64, u64, u64, i, p]
    lib.ar_chunk_data.restype = i
    lib.ar_close.argtypes = [p]
    lib.ar_close.restype = None
    lib.ar_writer_open.argtypes = [ctypes.c_char_p]
    lib.ar_writer_open.restype = p
    lib.ar_write_chunk.argtypes = [p, i, u64, u64, ctypes.c_char_p, u64]
    lib.ar_write_chunk.restype = i64
    lib.ar_pad_to_block_boundary.argtypes = [p]
    lib.ar_pad_to_block_boundary.restype = i64
    lib.ar_writer_close.argtypes = [p]
    lib.ar_writer_close.restype = i
    return lib


LIBRARY = _build.NativeLibrary(
    "array_record", _build.CSRC / "array_record.cc", compiler=_build.cxx,
    flags=_build.CXX_FLAGS, bind=_bind)


def highway_hash(data: bytes) -> int:
    """Riegeli's hash of ``data``: HighwayHash-64 keyed with
    ``"Riegeli/records\\n"`` twice (native)."""
    data = bytes(data)
    return int(LIBRARY.load().ar_highway_hash(data, len(data)))


def writer_options(group_size: int) -> str:
    """The options string the JAX package's writer records for
    ``ArrayRecordWriter(path, f"group_size:{group_size}")``."""
    return (f"group_size:{group_size},transpose:false,"
            "pad_to_block_boundary:false,zstd:3,window_log:20,"
            "max_parallelism:1")


# -- protobuf and simple chunks --------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _message(*fields: tuple[int, int | bytes]) -> bytes:
    """A proto of varint (int) and length-delimited (bytes) fields."""
    out = bytearray()
    for number, value in fields:
        if isinstance(value, int):
            out += _varint(number << 3) + _varint(value)
        else:
            out += _varint(number << 3 | 2) + _varint(len(value)) + value
    return bytes(out)


def _ints(message) -> dict[int, int]:
    return {n: v for n, wire, v in _fields(message) if wire == 0}


def _encode_simple(records: list[bytes], compress: bool) -> tuple[bytes,
                                                                   int]:
    """A simple chunk's data and decoded size."""
    sizes = b"".join(_varint(len(r)) for r in records)
    values = b"".join(records)
    decoded = len(values)
    if compress:
        sizes = _varint(len(sizes)) + zstd.compress(sizes)
        values = _varint(len(values)) + zstd.compress(values)
    head = bytes([_ZSTD if compress else _NONE]) + _varint(len(sizes))
    return head + sizes + values, decoded


def _decompress_section(section: np.ndarray) -> np.ndarray:
    size, pos = _read_varint(memoryview(section), 0)
    return zstd.decompress(section[pos:], size)


def _decode_simple(data: np.ndarray, num_records: int, decoded_size: int,
                   where: str) -> list[bytes]:
    """The records of a simple chunk's ``data`` (a uint8 array)."""
    if not len(data):
        raise ValueError(f"{where}: empty simple chunk")
    compression = int(data[0])
    if compression in _UNSUPPORTED_COMPRESSION:
        raise NotImplementedError(
            f"{where}: {_UNSUPPORTED_COMPRESSION[compression]} chunks are "
            "not supported (zstd or uncompressed only)")
    if compression not in (_ZSTD, _NONE):
        raise ValueError(f"{where}: unknown compression type {compression}")
    try:
        sizes_size, pos = _read_varint(memoryview(data), 1)
        sizes, values = data[pos:pos + sizes_size], data[pos + sizes_size:]
        if compression == _ZSTD:
            sizes, values = (_decompress_section(sizes),
                             _decompress_section(values))
        lengths, pos, view = [], 0, memoryview(sizes)
        while pos < len(view):
            n, pos = _read_varint(view, pos)
            lengths.append(n)
    except IndexError:      # a varint runs past its section
        raise ValueError(f"{where}: truncated simple chunk") from None
    if len(values) != decoded_size or len(lengths) != num_records or \
            sum(lengths) != len(values):
        raise ValueError(
            f"{where}: {len(lengths)} records of {sum(lengths)} bytes in "
            f"{len(values)} bytes of values; the chunk header says "
            f"{num_records} records of {decoded_size} bytes")
    bounds = np.cumsum([0] + lengths).tolist()
    return [values[a:b].tobytes() for a, b in zip(bounds, bounds[1:])]


# -- reader ----------------------------------------------------------------

class ArrayRecordFile:
    """Random access to one ArrayRecord file: ``reader[i] -> bytes``.

    Opening reads the postscript (in the last block) and the footer; a
    record read reads and decodes its chunk.  ``verify_hash`` also checks
    each chunk's data hash (header hashes are always checked).  Reads use
    ``pread`` and may come from several threads at once.  Picklable: it
    reopens lazily after unpickling."""

    def __init__(self, path: str, *, verify_hash: bool = False):
        self.path = os.fspath(path)
        self.verify_hash = verify_hash
        self._lock = threading.Lock()
        self._handle = None
        self._ensure_open()

    def _error(self, code: int, pos: int) -> Exception:
        text = LIBRARY.load().ar_error_string(code).decode()
        return ValueError(f"{self.path}: {text} in the chunk at {pos}")

    def _chunk(self, handle, pos: int) -> tuple[int, int, int, np.ndarray]:
        """(chunk type, record count, decoded size, data) of a chunk."""
        lib = LIBRARY.load()
        info = (ctypes.c_uint64 * 6)()
        rc = lib.ar_chunk_header(handle, pos, info)
        if rc:
            raise self._error(rc, pos)
        data_size, data_hash, chunk_type, num_records, decoded, _ = info
        if data_size > lib.ar_size(handle):
            raise ValueError(f"{self.path}: the chunk at {pos} claims "
                             f"{data_size} bytes, more than the file holds")
        data = np.empty(data_size, np.uint8)
        rc = lib.ar_chunk_data(handle, pos, data_size, data_hash,
                               1 if self.verify_hash else 0,
                               data.ctypes.data)
        if rc:
            raise self._error(rc, pos)
        return chunk_type, num_records, decoded, data

    def _records(self, handle, pos: int) -> list[bytes]:
        chunk_type, num_records, decoded, data = self._chunk(handle, pos)
        where = f"{self.path}: chunk at {pos}"
        if chunk_type == _TRANSPOSED:
            raise NotImplementedError(
                f"{where}: transposed chunks (transpose:true) are not "
                "supported")
        if chunk_type != _SIMPLE:
            raise ValueError(f"{where}: chunk type {chr(chunk_type)!r} "
                             "holds no records")
        return _decode_simple(data, num_records, decoded, where)

    def _ensure_open(self):
        with self._lock:
            if self._handle is not None:
                return
            lib = LIBRARY.load()
            handle = lib.ar_open(os.fsencode(self.path))
            if not handle:
                raise OSError(f"cannot open {self.path}")
            try:
                self._read_footer(handle, lib.ar_size(handle))
            except BaseException:
                lib.ar_close(handle)
                raise
            self._handle = handle
            self._closer = weakref.finalize(self, lib.ar_close, handle)

    def _read_footer(self, handle, size: int):
        if size < BLOCK_SIZE or size % BLOCK_SIZE:
            raise ValueError(
                f"{self.path}: truncated or not an ArrayRecord file ({size} "
                f"bytes is not a whole number of {BLOCK_SIZE}-byte blocks)")
        try:
            postscript = _ints(self._records(handle, size - BLOCK_SIZE)[0])
            if postscript.get(2) != _MAGIC:
                raise ValueError("bad postscript magic")
        except (ValueError, IndexError) as e:
            raise ValueError(
                f"{self.path}: no ArrayRecord postscript in the last block: "
                f"truncated or not an ArrayRecord file ({e})") from e
        footer = self._records(handle, postscript.get(1, 0))
        meta = {n: v for n, _, v in _fields(footer[0])}.get(1)
        if meta is None:
            raise ValueError(f"{self.path}: the footer has no "
                             "array_record_metadata")
        options = next((bytes(v).decode() for n, _, v in _fields(meta)
                        if n == 4), "")
        counts = _ints(meta)
        for option in options.split(","):
            if option == "transpose:true" or option.split(":")[0] in (
                    "brotli", "snappy"):
                raise NotImplementedError(
                    f"{self.path}: option {option!r} is not supported "
                    "(zstd or uncompressed simple chunks only)")
        entries = [_ints(e) for e in footer[1:]]
        self.writer_options = options
        self._chunk_offsets = [e.get(1, 0) for e in entries]
        self._chunk_starts, total = [], 0
        for e in entries:
            self._chunk_starts.append(total)
            total += e.get(3, 0)
        if len(entries) != counts.get(2, 0) or total != counts.get(3, 0):
            raise ValueError(
                f"{self.path}: the footer lists {len(entries)} chunks and "
                f"{total} records, its metadata {counts.get(2, 0)} and "
                f"{counts.get(3, 0)}")
        self._count = total
        # the last chunk decoded, so that a walk through a file of groups
        # decodes each chunk once
        self._last_chunk = (-1, [])

    def __len__(self) -> int:
        self._ensure_open()
        return self._count

    def __getitem__(self, i: int) -> bytes:
        self._ensure_open()
        i = int(i)
        if i < 0:
            i += self._count
        if not 0 <= i < self._count:
            raise IndexError(i)
        c = bisect.bisect_right(self._chunk_starts, i) - 1
        cached = self._last_chunk       # one tuple: safe across threads
        if cached[0] == c:
            records = cached[1]
        else:
            records = self._records(self._handle, self._chunk_offsets[c])
            self._last_chunk = (c, records)
        return records[i - self._chunk_starts[c]]

    def close(self):
        with self._lock:
            if self._handle is not None:
                self._closer()
                self._handle = None

    def __getstate__(self):
        return {"path": self.path, "verify_hash": self.verify_hash}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._handle = None


# -- writer ----------------------------------------------------------------

def write_array_record_file(path, records, *, group_size: int = 1) -> int:
    """Write ``records`` (bytes) to an ArrayRecord file with the JAX
    package's default options: zstd simple chunks of ``group_size``
    records.  Returns the record count."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    lib = LIBRARY.load()
    path = os.fspath(path)
    w = lib.ar_writer_open(os.fsencode(path))
    if not w:
        raise OSError(f"cannot create {path}")

    def put(chunk_type: int, chunk_records: list[bytes],
            compress: bool) -> int:
        data, decoded = _encode_simple(chunk_records, compress)
        pos = lib.ar_write_chunk(w, chunk_type, len(chunk_records), decoded,
                                 data, len(data))
        if pos < 0:
            raise OSError(f"{path}: {lib.ar_error_string(pos).decode()}")
        return pos

    def pad():
        if lib.ar_pad_to_block_boundary(w) < 0:
            raise OSError(f"{path}: write failed")

    try:
        if lib.ar_write_chunk(w, _SIGNATURE, 0, 0, b"", 0) < 0:
            raise OSError(f"{path}: write failed")
        entries, group, total = [], [], 0

        def flush():
            pos = put(_SIMPLE, group, True)
            decoded = sum(len(r) for r in group)
            entries.append(_message((1, pos), (2, decoded), (3, len(group))))
            group.clear()

        for record in records:
            group.append(bytes(record))
            total += 1
            if len(group) == group_size:
                flush()
        if group:
            flush()
        meta = _message((1, _message(
            (1, _FOOTER_VERSION), (2, len(entries)), (3, total),
            (4, writer_options(group_size).encode()))))
        footer_offset = put(_SIMPLE, [meta, *entries], True)
        pad()
        postscript = _message((1, footer_offset), (2, _MAGIC))
        put(_SIMPLE, [postscript] * 3, False)
        pad()
    finally:
        rc = lib.ar_writer_close(w)
    if rc:
        raise OSError(f"{path}: {lib.ar_error_string(rc).decode()}")
    return total
