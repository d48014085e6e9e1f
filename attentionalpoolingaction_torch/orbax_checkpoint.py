"""A reader of the JAX package's Orbax checkpoints in plain Python: the
read half of its ``checkpoint.py`` (``restore``, ``saved_tree_keys``,
``restore_for_eval``) on a machine without Orbax or tensorstore.

A step that the JAX package's ``checkpoint.save`` writes
(``StandardSave`` of a ``TrainState``, OCDBT and zarr v2, as
orbax-checkpoint 0.11 writes by default) is laid out as:

    <step>/_CHECKPOINT_METADATA        JSON; written last: the commit
    <step>/default/_METADATA           JSON: the tree, leaf by leaf
    <step>/default/manifest.ocdbt      the root of the key-value store
    <step>/default/d/*                 its B+tree nodes
    <step>/default/ocdbt.process_<i>/  process i's own store, whose data
                                       files hold the values

Three layers read it:

  * **OCDBT** (tensorstore's "OCDBT" key-value store format).  Every
    manifest and B+tree node is one encoded record: a big-endian magic
    number (``0x0cdb3a2a`` manifest, ``0x0cdb20de`` node), the record's
    length (u64 LE), a version varint (0), a compression varint (0 none,
    1 zstd), the body, and a CRC-32C (LE) of every byte before it.  The
    manifest holds the config and the versions; the latest version names
    the root node by (data file, offset, length).  A node holds its height,
    a table of the data files it refers to (each a base path and a path
    relative to it, resolved below the base path of the file that holds
    the node), and its keys, prefix-compressed.  An interior node's
    entries point at child nodes, whose keys lack the subtree's common
    prefix; a leaf's values are inline or held by reference (data file,
    offset, length).  Files are read with ``pread``, a record at a time.
  * **zarr v2.**  A key ``<path>/.zarray`` holds the array's JSON
    metadata, ``<path>/<i>.<j>...`` its chunks in C order, each one zstd
    frame; edge chunks are cropped to the shape.  ``bfloat16`` becomes
    ``torch.bfloat16``, the other dtypes numpy's.
  * **the tree.**  ``_METADATA`` lists every leaf by its path (dict keys,
    ``key_type`` 2, and sequence indices, ``key_type`` 1) and its type;
    the zarr path is the keys joined with ``.``.  Sequences become dicts
    keyed by int; an empty optax state is ``None``.

What the reader does not handle raises and names itself, with the file
where there is one: zarr3, a store without OCDBT, a compressor or filter
other than zstd, a dtype other than float32, int32 and bfloat16, a
numbered manifest, a missing chunk, a bad CRC or length.  A step without
``_CHECKPOINT_METADATA`` is not committed and raises too.

:func:`payload_of` turns a ``TrainState`` tree into the payload of the
port's own format (``checkpoint.py``): ``params`` and ``batch_stats``
through the weight bridge into ``model``, optax's state into the
optimizer's by parameter name (:func:`optimizer_state`), ``ema_params``.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
from typing import Any, Iterator

import numpy as np
import torch

from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch.data import native_io
from attentionalpoolingaction_torch.data import zstd
from attentionalpoolingaction_torch.tf_checkpoint import _varint

__all__ = ["COMMIT_FILE", "OcdbtStore", "is_orbax_step", "optimizer_state",
           "payload_keys", "payload_of", "read_array", "read_payload",
           "read_tree"]

COMMIT_FILE = "_CHECKPOINT_METADATA"
ITEM = "default"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_HEADER = struct.Struct(">IQ")             # magic (BE), length (LE below)
_RAW, _ZSTD = 0, 1
_SINGLE_MANIFEST = 0
_MISSING = (1 << 64) - 1                    # offset/length of an empty tree
# the dtypes of a TrainState's leaves
_ZARR_DTYPES = {"<f4", "<i4", "bfloat16"}
# TrainState's top-level keys -> the payload's
_PAYLOAD_KEYS = {"step": "step", "params": "model", "batch_stats": "model",
                 "opt_state": "optimizer", "ema_params": "ema_params"}


def is_orbax_step(step_dir) -> bool:
    """Whether ``step_dir`` is a step the JAX package wrote (committed or
    not)."""
    d = pathlib.Path(step_dir)
    return (d / COMMIT_FILE).exists() or (d / ITEM).is_dir()


# -- OCDBT --------------------------------------------------------------------

def _crc32c(data) -> int:
    """CRC-32C of ``data``, from the native library's masked one."""
    masked = (native_io.masked_crc32c(data) - 0xA282EAD8) & 0xFFFFFFFF
    return ((masked << 15) | (masked >> 17)) & 0xFFFFFFFF


def _decode_record(buf: bytes, magic: int, where: str) -> memoryview:
    """The body of one encoded manifest or node, its header and CRC
    checked."""
    if len(buf) < _HEADER.size + 2 + 4:
        raise ValueError(f"{where}: {len(buf)} bytes, too short for an "
                         "OCDBT record")
    got_magic = struct.unpack_from(">I", buf)[0]
    length = struct.unpack_from("<Q", buf, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{where}: magic {got_magic:#010x}, want "
                         f"{magic:#010x}")
    if length != len(buf):
        raise ValueError(f"{where}: the header says {length} bytes, the "
                         f"record has {len(buf)}")
    stored = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    if _crc32c(buf[:-4]) != stored:
        raise ValueError(f"{where}: CRC-32C mismatch (corrupt file)")
    version, pos = _varint(buf, _HEADER.size)
    if version != 0:
        raise ValueError(f"{where}: OCDBT format version {version}")
    compression, pos = _varint(buf, pos)
    body = memoryview(buf)[pos:-4]
    if compression == _ZSTD:
        return memoryview(zstd.decompress(body))
    if compression == _RAW:
        return body
    raise ValueError(f"{where}: OCDBT compression {compression}")


class _Reader:
    """Sequential varints and bytes of a decoded body."""

    def __init__(self, body: memoryview, where: str):
        self.body, self.pos, self.where = body, 0, where

    def varint(self) -> int:
        if self.pos >= len(self.body):
            raise ValueError(f"{self.where}: truncated body")
        value, self.pos = _varint(self.body, self.pos)
        return value

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.body):
            raise ValueError(f"{self.where}: truncated body")
        out = bytes(self.body[self.pos:self.pos + n])
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _prefixed(r: _Reader, n: int, extra: bool = False):
    """``n`` prefix-compressed byte strings (the first whole), and with
    ``extra`` a third varint column read between the lengths and the
    bytes (an interior node's subtree common prefix lengths)."""
    shared = [0] + r.varints(max(n - 1, 0))
    own = r.varints(n)
    third = r.varints(n) if extra else None
    out = []
    for i in range(n):
        prev = out[-1][:shared[i]] if out else b""
        if len(prev) != shared[i]:
            raise ValueError(f"{r.where}: a prefix longer than its key")
        out.append(prev + r.take(own[i]))
    return out, third


def _data_files(r: _Reader, base: str) -> list[tuple[str, str]]:
    """A data file table, each path resolved below ``base`` (the base path
    of the file that holds the table)."""
    n = r.varint()
    shared = [0] + r.varints(max(n - 1, 0))
    own = r.varints(n)
    base_lens = r.varints(n)
    paths = []
    for i in range(n):
        prev = paths[-1][:shared[i]] if paths else b""
        paths.append(prev + r.take(own[i]))
    for p, b in zip(paths, base_lens):
        if b > len(p):
            raise ValueError(f"{r.where}: a base path longer than its path")
    return [(base + p[:b].decode(), p[b:].decode())
            for p, b in zip(paths, base_lens)]


class OcdbtStore:
    """Every key of the OCDBT store under ``root`` (a directory holding
    ``manifest.ocdbt``) at its latest version, and its value:
    ``store[key] -> bytes``, ``key in store``, ``keys()``."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        # key -> inline bytes, or (path, offset, length)
        self._values: dict[bytes, Any] = {}
        self._fds: dict[str, int] = {}
        try:
            height, ref = self._manifest()
            if ref is not None:
                self._node(ref, height, b"")
        finally:
            self.close()

    def _read(self, path: str, offset: int, length: int) -> bytes:
        """``length`` bytes of the file ``path`` (below the root) from
        ``offset``, by ``pread``; a short read raises."""
        fd = self._fds.get(path)
        if fd is None:
            try:
                fd = self._fds[path] = os.open(self.root / path, os.O_RDONLY)
            except FileNotFoundError:
                raise ValueError(f"{self.root / path}: a data file that the "
                                 "store refers to is missing") from None
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise ValueError(f"{self.root / path}: {len(data)} bytes at "
                             f"{offset}, want {length} (truncated)")
        return data

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def _manifest(self):
        """(height, (base, path, offset, length)) of the latest version's
        root node; the reference is None for an empty store."""
        path = self.root / "manifest.ocdbt"
        where = str(path)
        try:
            buf = path.read_bytes()
        except FileNotFoundError:
            raise ValueError(f"{where} is missing: not an OCDBT store"
                             ) from None
        r = _Reader(_decode_record(buf, _MANIFEST_MAGIC, where), where)
        r.take(16)                                  # uuid
        kind = r.varint()
        if kind != _SINGLE_MANIFEST:
            raise ValueError(f"{where}: numbered manifests (kind {kind}) "
                             "are not read")
        r.varint()                                  # max_inline_value_bytes
        r.varint()                                  # max_decoded_node_bytes
        r.byte()                                    # version tree arity log2
        if r.varint() == _ZSTD:                     # the config's codec
            r.take(4)                               # its level, int32 LE
        files = _data_files(r, "")
        n = r.varint()
        generation = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        if n == 0:
            raise ValueError(f"{where}: no version")
        latest = max(range(n), key=generation.__getitem__)
        if offset[latest] == _MISSING:
            return 0, None
        return heights[latest], (*files[file_id[latest]], offset[latest],
                                 length[latest])

    def _node(self, ref, height: int, prefix: bytes) -> None:
        base, path, offset, length = ref
        where = f"{self.root / base / path} at {offset}"
        r = _Reader(_decode_record(self._read(base + path, offset, length),
                                   _NODE_MAGIC, where), where)
        got = r.byte()
        if got != height:
            raise ValueError(f"{where}: height {got}, its parent says "
                             f"{height}")
        files = _data_files(r, base)
        n = r.varint()
        if height:
            keys, common = _prefixed(r, n, extra=True)
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)        # the children's key and byte counts
            for i in range(n):
                self._node((*files[ids[i]], offsets[i], lengths[i]),
                           height - 1, prefix + keys[i][:common[i]])
            return
        keys, _ = _prefixed(r, n)
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = r.take(lengths[i])
            elif kinds[i] == 1:
                fid, off = refs[i]
                self._values[prefix + keys[i]] = (
                    "".join(files[fid]), off, lengths[i])
            else:
                raise ValueError(f"{where}: value kind {kinds[i]}")

    def keys(self) -> Iterator[bytes]:
        return iter(self._values)

    def __contains__(self, key) -> bool:
        return key in self._values

    def __getitem__(self, key: bytes) -> bytes:
        value = self._values[key]
        if isinstance(value, bytes):
            return value
        try:
            return self._read(*value)
        finally:
            self.close()

    def read_many(self, keys) -> list[bytes]:
        """The values of ``keys``, the data files kept open between
        reads."""
        try:
            return [v if isinstance(v, bytes) else self._read(*v)
                    for v in (self._values[k] for k in keys)]
        finally:
            self.close()


# -- zarr v2 ------------------------------------------------------------------

def _zarray(store: OcdbtStore, name: str) -> dict:
    key = f"{name}/.zarray".encode()
    if key not in store:
        raise ValueError(f"{store.root}: no {key.decode()} (not a zarr v2 "
                         "array; zarr3 arrays are not read)")
    meta = json.loads(store[key])
    where = f"{store.root}: {name}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')}")
    compressor = meta.get("compressor") or {}
    if compressor.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {meta.get('compressor')}; "
                         "the reader handles zstd only")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']} are not read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']}")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{where}: dimension separator "
                         f"{meta['dimension_separator']!r}")
    if meta["dtype"] not in _ZARR_DTYPES:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not read")
    return meta


def read_array(store: OcdbtStore, name: str):
    """The zarr v2 array ``name`` of ``store``: a numpy array, or a
    ``torch.bfloat16`` tensor."""
    meta = _zarray(store, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    coords = list(np.ndindex(*grid)) if shape else [()]
    keys = [(f"{name}/" + (".".join(map(str, c)) if c else "0")).encode()
            for c in coords]
    for k in keys:
        if k not in store:
            raise ValueError(
                f"{store.root}: chunk {k.decode()} is missing (fill_value "
                f"{meta.get('fill_value')}; a partial array is not read)")
    frames = store.read_many(keys)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    out = None if len(coords) == 1 else np.empty(shape, dtype)
    for c, frame in zip(coords, frames):
        try:
            raw = zstd.decompress(frame, chunk_bytes)
        except ValueError as e:
            raise ValueError(f"{store.root}: chunk {name}/{c}: {e}") from None
        block = raw.view(dtype).reshape(chunks)
        lo = [i * n for i, n in zip(c, chunks)]
        crop = tuple(slice(0, min(n, s - o))
                     for n, s, o in zip(chunks, shape, lo))
        if out is None:
            out = block[crop]
        else:
            out[tuple(slice(o, o + s.stop) for o, s in zip(lo, crop))] = \
                block[crop]
    out = np.array(out, dtype.newbyteorder("="), order="C")
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# -- the tree -----------------------------------------------------------------

def _metadata(step_dir: pathlib.Path) -> dict:
    if not (step_dir / COMMIT_FILE).exists():
        raise ValueError(f"{step_dir} has no {COMMIT_FILE}: an Orbax step "
                         "that was not committed")
    path = step_dir / ITEM / "_METADATA"
    try:
        meta = json.loads(path.read_text())
    except FileNotFoundError:
        raise ValueError(f"{path} is missing: not an Orbax PyTree item"
                         ) from None
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays (use_zarr3) are not read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: a step without OCDBT (use_ocdbt false) "
                         "is not read")
    return meta["tree_metadata"]


def _leaves(tree_meta: dict):
    """(keys, value type) of every leaf: keys are str for dict keys and
    int for sequence indices."""
    for entry in tree_meta.values():
        keys = tuple(int(k["key"]) if k["key_type"] == 1 else str(k["key"])
                     for k in entry["key_metadata"])
        yield keys, entry["value_metadata"]["value_type"]


def read_tree(step_dir, *, skip=()) -> dict:
    """The tree of the step ``step_dir`` wrote, leaves numpy arrays (or
    ``torch.bfloat16`` tensors) and ``None`` for empty states; the
    top-level keys in ``skip`` are left out unread."""
    step_dir = pathlib.Path(step_dir)
    leaves = [x for x in _leaves(_metadata(step_dir)) if x[0][0] not in skip]
    store = OcdbtStore(step_dir / ITEM)
    tree: dict = {}
    for keys, vtype in leaves:
        if vtype == "None":
            value = None
        elif vtype in ("jax.Array", "np.ndarray", "scalar"):
            value = read_array(store, ".".join(map(str, keys)))
        else:
            raise ValueError(f"{step_dir}: leaf {keys} of type {vtype!r} is "
                             "not read")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def payload_keys(step_dir) -> set[str]:
    """The payload keys that the step holds, from its metadata alone."""
    return {_PAYLOAD_KEYS[keys[0]] for keys, vtype
            in _leaves(_metadata(pathlib.Path(step_dir)))
            if vtype != "None" and keys[0] in _PAYLOAD_KEYS}


# -- the payload --------------------------------------------------------------

def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(torch.float32).numpy()
    return tree


def _optax_states(tree, path=()):
    """(path, node) of every optax state of ``tree``: a dict with a
    ``trace``, a ``mu`` or a ``count`` field.  Empty states (``None``)
    and containers are passed over; a container holding an array raises."""
    if tree is None:
        return
    if not isinstance(tree, dict):
        raise ValueError(f"an array at opt_state/{'/'.join(map(str, path))} "
                         "outside any optax state")
    if {"trace", "mu", "count"} & set(tree):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _optax_states(v, path + (k,))


def optimizer_state(opt_state, step: int) -> dict:
    """The optimizer state by parameter name, from optax's: ``trace``
    (SGD's momentum) becomes ``momentum_buffer``; ``mu``, ``nu`` and their
    ``count`` become AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``.
    The optax states are found by their field names, not by their place
    in the chain (it moves with the clip).  The schedule's ``count`` is
    the count the learning rate is keyed on, which the port keys on
    ``step``: the two must agree."""
    by_name: dict[str, dict] = {}
    counts = []
    for path, node in _optax_states(opt_state):
        fields = {k for k, v in node.items() if v is not None}
        if fields == {"trace"}:
            for name, t in convert.flax_to_state_dict(
                    _f32(node["trace"])).items():
                by_name.setdefault(name, {})["momentum_buffer"] = t
        elif fields == {"mu", "nu", "count"}:
            count = float(np.asarray(node["count"]))
            mu = convert.flax_to_state_dict(_f32(node["mu"]))
            nu = convert.flax_to_state_dict(_f32(node["nu"]))
            for name in mu:
                by_name.setdefault(name, {}).update(
                    step=torch.tensor(count), exp_avg=mu[name],
                    exp_avg_sq=nu[name])
        elif fields == {"count"}:
            counts.append(int(np.asarray(node["count"])))
        else:
            raise ValueError(f"optimizer state at opt_state/"
                             f"{'/'.join(map(str, path))} with fields "
                             f"{sorted(fields)} has no counterpart")
    if any(c != step for c in counts):
        raise ValueError(f"the schedule's count {counts} is not the step "
                         f"{step} that the learning rate is keyed on")
    return by_name


def payload_of(tree: dict, *, optimizer: bool = True) -> dict:
    """The port's payload (``checkpoint.py``) of a ``TrainState`` tree as
    :func:`read_tree` gives it: ``step``, ``model`` (CPU float32 tensors,
    and the batch norms' ``num_batches_tracked``, which the port never
    counts), ``optimizer`` (``{"state": {parameter name: buffers}}``,
    unless ``optimizer`` is False; no ``param_groups``: the
    hyperparameters are the config's) and ``ema_params`` when the tree
    has one."""
    step = int(np.asarray(tree["step"]))
    model = convert.flax_to_state_dict(
        _f32(tree["params"]), _f32(tree.get("batch_stats") or {}))
    for key in [k for k in model if k.endswith(".running_mean")]:
        model[key.removesuffix("running_mean") + "num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)
    out = {"step": step, "model": model}
    if optimizer:
        out["optimizer"] = {"state": optimizer_state(
            tree.get("opt_state"), step)}
    if tree.get("ema_params") is not None:
        out["ema_params"] = convert.flax_to_state_dict(
            _f32(tree["ema_params"]))
    return out


def read_payload(step_dir, *, optimizer: bool = True) -> dict:
    """:func:`payload_of` the step ``step_dir`` (its optimizer state left
    unread without ``optimizer``)."""
    return payload_of(read_tree(step_dir, skip=() if optimizer
                                else ("opt_state",)), optimizer=optimizer)
