"""A reader of TensorFlow checkpoint files in plain Python: the port's
stand-in for ``tf.train.load_checkpoint``, for TF-slim ImageNet weights
on a machine without TensorFlow or ``protobuf``; and a writer of V2
bundles (:func:`write_v2`), its inverse.

Two layouts:

  * **V2 bundle** (``tf.train.Saver`` since TF 1.x, ``tf.train.Checkpoint``):
    ``<prefix>.index``, a LevelDB-format table whose ``""`` key holds a
    ``BundleHeaderProto`` and whose other keys map tensor names to
    ``BundleEntryProto`` (dtype, shape, shard, offset, size), and the
    shards ``<prefix>.data-SSSSS-of-NNNNN`` with the raw little-endian
    values.
  * **V1** (``SaverDef.V1``, the model zoo's ``*.ckpt`` single files): one
    LevelDB-format table of ``SavedTensorSlices`` protos; the ``""`` key
    holds the meta (names, shapes, dtypes, slices), every other key one
    slice's ``TensorProto``, its values in ``tensor_content`` or in the
    packed (or unpacked) ``float_val`` / ``int64_val``.

Protobuf fields and varints are decoded by hand.  The reader raises
``NotImplementedError`` on what it does not handle: compressed table
blocks, partitioned variables (a tensor in several slices) and dtypes
other than float32 and int64 (those raise when the tensor is read; the
shape map lists every variable).

No crc32c is checked, neither the table blocks' nor the tensors': a
crc32c in pure Python runs at a few MB/s, minutes for the ~180 MB
ResNet-101 file.  Sizes are checked against shapes, so a truncated file
raises.

:func:`write_v2` writes what TF's ``BundleWriter`` writes for float32 and
int64 variables: the tensors end to end in ``<prefix>.data-00000-of-00001``
and ``<prefix>.index``, a table (uncompressed blocks of up to 256 KiB,
restart points every 16 keys, each block followed by its type byte and
masked CRC-32C, then the empty metaindex block, the index block, keyed
by LevelDB's shortest separators, and the 48-byte footer) of the
``BundleHeaderProto`` under ``""`` and a ``BundleEntryProto`` a name
(dtype, shape, offset, size, the tensor's masked CRC-32C).  The CRCs
come from the native library (``data/native_io.py``).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

import numpy as np

__all__ = ["CheckpointReader", "write_v2"]

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_BYTES = 48
_BLOCK_TRAILER_BYTES = 5         # compression type, masked crc32c
_BLOCK_BYTES = 262144            # TF's table::Options block_size
_RESTART_INTERVAL = 16
_BUNDLE_VERSION = 1              # kTensorBundleVersion
# TensorFlow's DataType enum: the two a slim checkpoint holds
_DTYPES = {1: np.dtype("<f4"), 9: np.dtype("<i8")}
_DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8",
                5: "int16", 6: "int8", 7: "string", 9: "int64", 10: "bool",
                14: "bfloat16", 19: "float16"}


# -- protobuf wire format --------------------------------------------------

def _varint(buf, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf) -> Iterator[tuple[int, int, object]]:
    """(field number, wire type, value) of one serialized message: an int
    for varints, a memoryview for length-delimited, fixed32 and fixed64
    fields."""
    buf = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield number, wire, value


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _shape(buf) -> tuple[int, ...]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims = []
    for number, _, value in _fields(buf):
        if number == 2:
            size = 0
            for n, _, v in _fields(value):
                if n == 1:
                    size = _int64(v)
            dims.append(size)
        elif number == 3 and value:
            raise NotImplementedError("a tensor of unknown rank")
    return tuple(dims)


def _is_full_slice(buf) -> bool:
    """TensorSliceProto: an extent with a start or a length is partial."""
    for number, _, extent in _fields(buf):
        if number == 1 and any(True for _ in _fields(extent)):
            return False
    return True


# -- LevelDB table ---------------------------------------------------------

def _block_entries(data, handle) -> Iterator[tuple[bytes, memoryview]]:
    """(key, value) of the block that ``handle`` (varint offset, size)
    points at; keys are prefix-compressed against the previous one."""
    offset, pos = _varint(handle, 0)
    size, _ = _varint(handle, pos)
    if offset + size + _BLOCK_TRAILER_BYTES > len(data):
        raise ValueError("table block past the end of the file (truncated?)")
    if data[offset + size] != 0:
        raise NotImplementedError(
            f"compressed table block (type {data[offset + size]}); the "
            "reader handles uncompressed tables only")
    block = data[offset:offset + size]
    num_restarts = struct.unpack_from("<I", block, size - 4)[0]
    limit = size - 4 * (num_restarts + 1)
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        own, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + own])
        pos += own
        yield key, block[pos:pos + vlen]
        pos += vlen


def _table_entries(data) -> Iterator[tuple[bytes, memoryview]]:
    """Every (key, value) of a LevelDB-format table held in ``data``."""
    data = memoryview(data)
    if len(data) < _FOOTER_BYTES:
        raise ValueError("not a TensorFlow checkpoint table (too short)")
    footer = data[-_FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, _FOOTER_BYTES - 8)[0] != _TABLE_MAGIC:
        raise ValueError("not a TensorFlow checkpoint table (bad magic)")
    _, pos = _varint(footer, 0)              # the metaindex: unused
    _, pos = _varint(footer, pos)
    for _, handle in _block_entries(data, footer[pos:]):
        yield from _block_entries(data, handle)


# -- the reader --------------------------------------------------------------

class CheckpointReader:
    """``get_variable_to_shape_map()`` and ``get_tensor(name)``, as TF's
    reader gives them, over the V2 checkpoint whose prefix is ``path`` or
    the V1 checkpoint file ``path`` (see the module)."""

    def __init__(self, path: str):
        self.path = path
        # name -> (dtype enum, shape, locator); the locator reads the bytes
        self._entries: dict[str, tuple] = {}
        if os.path.exists(path + ".index"):
            self._open_v2(path)
        elif os.path.isfile(path):
            self._open_v1(path)
        else:
            raise FileNotFoundError(
                f"no TensorFlow checkpoint at {path}: neither {path}.index "
                f"(V2) nor the file {path} (V1)")

    def _open_v2(self, prefix: str):
        with open(prefix + ".index", "rb") as f:
            index = f.read()
        num_shards = 1
        for key, value in _table_entries(index):
            if key == b"":
                for number, _, v in _fields(value):
                    if number == 1:
                        num_shards = v
                    elif number == 2 and v != 0:
                        raise NotImplementedError("a big-endian bundle")
                continue
            if key.startswith(b"\x00"):      # one slice of a partitioned var
                continue
            dtype, shape, shard, offset, size, partitioned = 0, (), 0, 0, 0, \
                False
            for number, _, v in _fields(value):
                if number == 1:
                    dtype = v
                elif number == 2:
                    shape = _shape(v)
                elif number == 3:
                    shard = v
                elif number == 4:
                    offset = _int64(v)
                elif number == 5:
                    size = _int64(v)
                elif number == 7:
                    partitioned = True
            shard_path = f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"
            self._entries[key.decode()] = (
                dtype, shape, ("v2", shard_path, offset, size, partitioned))

    def _open_v1(self, path: str):
        with open(path, "rb") as f:
            self._v1_data = f.read()         # the values live in the table
        meta, data = {}, {}
        for key, value in _table_entries(self._v1_data):
            for number, _, v in _fields(value):
                if number == 1:              # SavedTensorSliceMeta
                    for n, _, t in _fields(v):
                        if n == 1:           # SavedSliceMeta
                            name, shape, dtype, slices = "", (), 0, []
                            for m, _, x in _fields(t):
                                if m == 1:
                                    name = bytes(x).decode()
                                elif m == 2:
                                    shape = _shape(x)
                                elif m == 3:
                                    dtype = x
                                elif m == 4:
                                    slices.append(x)
                            meta[name] = (dtype, shape, slices)
                elif number == 2:            # SavedSlice
                    name, tensor, full = "", None, True
                    for m, _, x in _fields(v):
                        if m == 1:
                            name = bytes(x).decode()
                        elif m == 2:
                            full = _is_full_slice(x)
                        elif m == 3:
                            tensor = x
                    data.setdefault(name, []).append((full, tensor))
        for name, (dtype, shape, slices) in meta.items():
            partitioned = (len(slices) != 1 or not _is_full_slice(slices[0])
                           or len(data.get(name, ())) != 1
                           or not data[name][0][0])
            tensor = None if partitioned else data[name][0][1]
            self._entries[name] = (dtype, shape, ("v1", tensor, partitioned))

    def get_variable_to_shape_map(self) -> dict[str, list[int]]:
        return {name: list(shape)
                for name, (_, shape, _) in self._entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        """The variable ``name`` as a new numpy array."""
        try:
            dtype_enum, shape, loc = self._entries[name]
        except KeyError:
            raise KeyError(f"{name} not in checkpoint {self.path}") from None
        if loc[-1]:
            raise NotImplementedError(
                f"{name} is a partitioned variable (saved in slices); the "
                "reader handles whole tensors only")
        if dtype_enum not in _DTYPES:
            raise NotImplementedError(
                f"{name} has dtype "
                f"{_DTYPE_NAMES.get(dtype_enum, dtype_enum)}; the reader "
                "handles float32 and int64")
        dtype = _DTYPES[dtype_enum]
        count = int(np.prod(shape, dtype=np.int64))
        if loc[0] == "v2":
            _, shard_path, offset, size, _ = loc
            if size != count * dtype.itemsize:
                raise ValueError(f"{name}: {size} bytes for shape {shape}")
            with open(shard_path, "rb") as f:
                f.seek(offset)
                raw = f.read(size)
            if len(raw) != size:
                raise ValueError(f"{name}: {shard_path} is truncated")
            flat = np.frombuffer(raw, dtype)
        else:
            flat = self._v1_values(name, loc[1], dtype_enum, dtype)
        if flat.size != count:
            raise ValueError(f"{name}: {flat.size} values for shape {shape}")
        return flat.reshape(shape).astype(dtype.newbyteorder("="))

    @staticmethod
    def _v1_values(name, tensor, dtype_enum, dtype) -> np.ndarray:
        """The values of one TensorProto: ``tensor_content`` (4), or
        ``float_val`` (5) / ``int64_val`` (10), packed or not."""
        parts = []
        field = 5 if dtype_enum == 1 else 10
        for number, wire, v in _fields(tensor):
            if number == 4:
                return np.frombuffer(v, dtype)
            if number != field:
                continue
            if wire == 2 and field == 5:       # packed floats
                parts.append(np.frombuffer(v, dtype))
            elif wire == 5:                    # one unpacked float
                parts.append(np.frombuffer(v, dtype))
            elif wire == 2:                    # packed varints
                pos, vals = 0, []
                while pos < len(v):
                    x, pos = _varint(v, pos)
                    vals.append(_int64(x))
                parts.append(np.array(vals, dtype))
            else:                              # one unpacked varint
                parts.append(np.array([_int64(v)], dtype))
        if not parts:
            return np.zeros(0, dtype)
        return np.concatenate(parts)



# -- the writer ---------------------------------------------------------------

def _put_varint(out: bytearray, value: int) -> None:
    while value >= 0x80:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)


def _field(out: bytearray, number: int, value) -> None:
    """One protobuf field: an int as a varint, bytes length-delimited."""
    if isinstance(value, int):
        _put_varint(out, number << 3)
        _put_varint(out, value)
    else:
        _put_varint(out, number << 3 | 2)
        _put_varint(out, len(value))
        out += value


def _block(entries, restart_interval: int) -> bytes:
    """One table block: the entries, keys prefix-compressed against the
    previous one, restarting every ``restart_interval``."""
    out, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % restart_interval:
            while (shared < min(len(key), len(prev))
                   and key[shared] == prev[shared]):
                shared += 1
        else:
            restarts.append(len(out))
        for v in (shared, len(key) - shared, len(value)):
            _put_varint(out, v)
        out += key[shared:] + value
        prev = key
    for r in restarts or [0]:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts or [0]))
    return bytes(out)


def _separator(start: bytes, limit: bytes | None) -> bytes:
    """A short key >= ``start`` and < ``limit`` (LevelDB's bytewise
    ``FindShortestSeparator``; with no ``limit``, ``FindShortSuccessor``):
    the index key of the block that ends with ``start``."""
    if limit is None:
        for i, b in enumerate(start):
            if b != 0xFF:
                return start[:i] + bytes([b + 1])
        return start
    n = 0
    while n < min(len(start), len(limit)) and start[n] == limit[n]:
        n += 1
    if n < min(len(start), len(limit)):
        b = start[n]
        if b < 0xFF and b + 1 < limit[n]:
            return start[:n] + bytes([b + 1])
    return start


def _table(entries) -> bytes:
    """A LevelDB-format table of ``entries``, (key, value) sorted by key."""
    from attentionalpoolingaction_torch.data import native_io

    out, index = bytearray(), []

    def put(block: bytes) -> bytes:
        handle = bytearray()
        _put_varint(handle, len(out))
        _put_varint(handle, len(block))
        out.extend(block + b"\0")
        out.extend(struct.pack("<I", native_io.masked_crc32c(block + b"\0")))
        return bytes(handle)

    start = size = 0
    for i, (key, value) in enumerate(entries):
        size += len(key) + len(value) + 12
        if size >= _BLOCK_BYTES or i == len(entries) - 1:
            block = entries[start:i + 1]
            following = entries[i + 1][0] if i + 1 < len(entries) else None
            index.append((_separator(block[-1][0], following),
                          put(_block(block, _RESTART_INTERVAL))))
            start, size = i + 1, 0
    metaindex = put(_block([], _RESTART_INTERVAL))
    index_handle = put(_block(index, 1))
    footer = (metaindex + index_handle).ljust(_FOOTER_BYTES - 8, b"\0")
    out += footer + struct.pack("<Q", _TABLE_MAGIC)
    return bytes(out)


def write_v2(prefix: str, tensors) -> int:
    """Write ``tensors`` (name -> float32 or int64 array) as the V2
    checkpoint ``prefix`` (``prefix.index`` and
    ``prefix.data-00000-of-00001``); returns how many were written."""
    from attentionalpoolingaction_torch.data import native_io

    codes = {dt: code for code, dt in _DTYPES.items()}
    entries, offset = [], 0
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for name in sorted(tensors):
            a = np.asarray(tensors[name])
            code = codes.get(a.dtype.newbyteorder("<"))
            if code is None:
                raise NotImplementedError(
                    f"{name} has dtype {a.dtype}; the writer handles "
                    "float32 and int64")
            raw = np.ascontiguousarray(a, a.dtype.newbyteorder("<")
                                       ).tobytes()
            f.write(raw)
            shape = bytearray()
            for d in a.shape:
                dim = bytearray()
                _field(dim, 1, d)
                _field(shape, 2, bytes(dim))
            entry = bytearray()
            _field(entry, 1, code)
            _field(entry, 2, bytes(shape))
            if offset:
                _field(entry, 4, offset)
            _field(entry, 5, len(raw))
            _put_varint(entry, 6 << 3 | 5)
            entry += struct.pack("<I", native_io.masked_crc32c(raw))
            entries.append((name.encode(), bytes(entry)))
            offset += len(raw)
    version, header = bytearray(), bytearray()
    _field(version, 1, _BUNDLE_VERSION)
    _field(header, 1, 1)                  # num_shards
    _field(header, 3, bytes(version))
    with open(f"{prefix}.index", "wb") as f:
        f.write(_table([(b"", bytes(header))] + entries))
    return len(entries)
