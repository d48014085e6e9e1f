"""TFRecord example schema, writers and a parser of ``tf.train.Example``:
the port's copy of the JAX package's ``data/records.py``, with the
protobuf encoded and decoded by hand (the card's machine has neither
TensorFlow nor ``protobuf``).

Feature keys (the JAX package's canonical schema):
  image/encoded        bytes   JPEG
  image/height, /width int64
  image/class/label    int64   single class id (MPII, HMDB51)
  image/class/multi_hot int64[] C-length 0/1 vector (HICO)
  image/class/anno     int64[] C-length {+1,-1,0} raw annotation (HICO;
                               optional, all-zero when absent)
  image/pose/keypoints  float[] K*2 (y, x) image-pixel coords (MPII)
  image/pose/visibility float[] K     0/1
  video/id             int64   video index (HMDB51 per-frame records)
  video/frame          int64   frame index within the video

TFRecord framing, per record: uint64 length | uint32 masked crc32c of the
length | data | uint32 masked crc32c of the data.  The writers take the
checksums from the native library (``native_io.masked_crc32c``);
``_crc32c`` is the JAX package's pure-Python one, kept as the plain
version the tests hold the native one against.

``write_array_record`` writes ArrayRecord files with the port's own codec
(``data/array_record.py``).  Not ported: ``feature_description`` (a
``tf.io`` parse spec; the port parses with :func:`parse_example`).
"""

from __future__ import annotations

import os
import struct
from typing import Callable

import numpy as np

from attentionalpoolingaction_torch.data import array_record, native_io
from attentionalpoolingaction_torch.data.datasets import DatasetSpec
from attentionalpoolingaction_torch.tf_checkpoint import (
    _fields,
    _int64,
    _varint as _read_varint,
)

__all__ = ["ShardedTFRecordWriter", "decode_example", "encode_field",
           "make_example", "parse_example", "read_tfrecord",
           "write_array_record", "write_framed", "write_synthetic_dataset",
           "write_tfrecord"]

# -- TFRecord framing -----------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC32C (Castagnoli) in pure Python: the plain version of the native
    checksum."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc_py(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def write_framed(f, data: bytes) -> None:
    """TFRecord wire framing: length + masked-CRC header, data, data CRC."""
    length = struct.pack("<Q", len(data))
    f.write(length)
    f.write(struct.pack("<I", native_io.masked_crc32c(length)))
    f.write(data)
    f.write(struct.pack("<I", native_io.masked_crc32c(data)))


def write_tfrecord(path, serialized_examples) -> None:
    """Write serialized example protos to a TFRecord file."""
    with open(path, "wb") as f:
        for data in serialized_examples:
            write_framed(f, data)


class ShardedTFRecordWriter:
    """Streaming sharded TFRecord writer: every ``write`` frames the record
    and appends it to its shard file at once, so nothing accumulates in
    memory.  Records round-robin across shards unless ``shard=`` pins
    one.  Use as a context manager; ``count`` totals records written."""

    def __init__(self, out_dir: str, split: str, shards: int):
        os.makedirs(out_dir, exist_ok=True)
        self.paths = [
            os.path.join(out_dir,
                         f"{split}-{i:05d}-of-{shards:05d}.tfrecord")
            for i in range(shards)]
        self._files = [open(p, "wb") for p in self.paths]
        self.count = 0

    def write(self, data: bytes, shard: int | None = None):
        f = self._files[(self.count if shard is None else shard)
                        % len(self._files)]
        write_framed(f, data)
        self.count += 1

    def close(self):
        for f in self._files:
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_array_record(path, serialized_examples, *, group_size: int = 1):
    """Write serialized example protos to an ArrayRecord file (its footer
    is the index: no sidecar).  ``group_size=1`` keeps every record
    seekable alone, the right trade for the pipeline's global shuffle."""
    array_record.write_array_record_file(path, serialized_examples,
                                         group_size=group_size)


def read_tfrecord(path):
    """Yield serialized example protos from a TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            data = f.read(length)
            f.read(4)  # data crc
            yield data


# -- protobuf wire format (encoder) --------------------------------------------

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1          # int64 as two's complement
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def encode_field(number: int, wire: int, payload) -> bytes:
    """One field: its tag, then a varint (wire 0), 8 bytes (wire 1), a
    length-prefixed payload (wire 2) or 4 bytes (wire 5)."""
    tag = _varint(number << 3 | wire)
    if wire == 0:
        return tag + _varint(int(payload))
    if wire == 2:
        return tag + _varint(len(payload)) + bytes(payload)
    return tag + bytes(payload)


def _bytes_feature(value: bytes) -> bytes:
    # Feature.bytes_list = 1 { repeated bytes value = 1 }
    return encode_field(1, 2, encode_field(1, 2, value))


def _int64_feature(values) -> bytes:
    # Feature.int64_list = 3 { repeated int64 value = 1 [packed] }
    packed = b"".join(_varint(int(v)) for v in np.asarray(values).reshape(-1))
    return encode_field(3, 2, encode_field(1, 2, packed))


def _float_feature(values) -> bytes:
    # Feature.float_list = 2 { repeated float value = 1 [packed] }
    packed = np.asarray(values, "<f4").reshape(-1).tobytes()
    return encode_field(2, 2, encode_field(1, 2, packed))


def make_example(image_jpeg: bytes, *, height: int, width: int,
                 label: int | None = None,
                 multi_hot: np.ndarray | None = None,
                 anno: np.ndarray | None = None,
                 keypoints: np.ndarray | None = None,
                 visibility: np.ndarray | None = None,
                 video_id: int | None = None,
                 frame: int | None = None) -> bytes:
    """A serialized ``tf.train.Example`` of the schema above, its
    features in key order: the bytes ``SerializeToString(deterministic=
    True)`` gives for TensorFlow's own example."""
    feat = {
        "image/encoded": _bytes_feature(image_jpeg),
        "image/height": _int64_feature([height]),
        "image/width": _int64_feature([width]),
    }
    if label is not None:
        feat["image/class/label"] = _int64_feature([label])
    if multi_hot is not None:
        feat["image/class/multi_hot"] = _int64_feature(multi_hot)
    if anno is not None:
        feat["image/class/anno"] = _int64_feature(anno)
    if keypoints is not None:
        feat["image/pose/keypoints"] = _float_feature(keypoints)
        feat["image/pose/visibility"] = _float_feature(
            visibility if visibility is not None
            else np.ones(len(keypoints)))
    if video_id is not None:
        feat["video/id"] = _int64_feature([video_id])
        feat["video/frame"] = _int64_feature([frame or 0])
    # Features.feature = 1: map<string, Feature>, one entry message each,
    # in key order (protobuf's deterministic serialization); TensorFlow's
    # map order changes from process to process
    entries = b"".join(
        encode_field(1, 2, encode_field(1, 2, k.encode()) +
                     encode_field(2, 2, v))
        for k, v in sorted(feat.items()))
    return encode_field(1, 2, entries)          # Example.features = 1


# -- protobuf wire format (decoder) --------------------------------------------

def _decode_list(kind: int, body) -> bytes | list | np.ndarray:
    if kind == 1:                               # BytesList: repeated bytes
        return [bytes(v) for n, _, v in _fields(body) if n == 1]
    if kind == 2:                               # FloatList, packed or not
        parts = []
        for n, wire, v in _fields(body):
            if n == 1:
                parts.append(np.frombuffer(v, "<f4"))
        return (np.concatenate(parts) if parts
                else np.zeros(0, np.float32)).astype(np.float32)
    values = []                                 # Int64List, packed or not
    for n, wire, v in _fields(body):
        if n != 1:
            continue
        if wire == 0:
            values.append(_int64(v))
        else:
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                values.append(_int64(x))
    return np.asarray(values, np.int64)


def decode_example(raw: bytes) -> dict:
    """Every feature of a serialized ``tf.train.Example``: a list of bytes,
    a float32 array or an int64 array, by key."""
    out = {}
    for n, _, features in _fields(raw):
        if n != 1:
            continue
        for m, _, entry in _fields(features):
            if m != 1:
                continue
            key, feature = "", b""
            for k, _, v in _fields(entry):
                if k == 1:
                    key = bytes(v).decode()
                elif k == 2:
                    feature = v
            value = []
            for kind, _, body in _fields(feature):
                value = _decode_list(kind, body)
            out[key] = value
    return out


def _first(feats: dict, key: str) -> int:
    values = feats.get(key, [])
    if len(values) == 0:
        raise KeyError(f"the example has no {key!r}")
    return int(values[0])


def parse_example(raw: bytes, spec: DatasetSpec, *,
                  include_anno: bool = False) -> dict:
    """Parse a serialized ``tf.train.Example`` into the numpy features of
    the JAX package's ``grain_pipeline.parse_example``: ``image_bytes``,
    ``label`` (int32, or the float32 multi-hot), ``anno`` (int32, all zero
    when the record has none; with ``include_anno``), ``keypoints``
    (K, 2) and ``visibility`` (K,) for pose, ``video_id`` and ``frame``
    for video."""
    feats = decode_example(raw)
    images = feats.get("image/encoded", [])
    if not images:
        raise KeyError("the example has no 'image/encoded'")
    out = {"image_bytes": images[0]}
    if spec.multi_label:
        out["label"] = np.asarray(
            feats.get("image/class/multi_hot", []), np.float32)
        if include_anno:
            anno = np.asarray(feats.get("image/class/anno", []), np.int32)
            out["anno"] = (anno if anno.size == spec.num_classes
                           else np.zeros(spec.num_classes, np.int32))
    else:
        out["label"] = np.int32(_first(feats, "image/class/label"))
    if spec.has_pose:
        out["keypoints"] = np.asarray(
            feats.get("image/pose/keypoints", []),
            np.float32).reshape(spec.num_joints, 2)
        out["visibility"] = np.asarray(
            feats.get("image/pose/visibility", []), np.float32)
    if spec.is_video:
        out["video_id"] = np.int32(_first(feats, "video/id"))
        fr = feats.get("video/frame", [])
        out["frame"] = np.int32(fr[0] if len(fr) else 0)
    return out


# -- synthetic data ------------------------------------------------------------

def _cv2_encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """JPEG bytes of an RGB uint8 image, by OpenCV (4:2:0)."""
    import cv2

    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(image, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        raise ValueError("cv2.imencode failed")
    return buf.tobytes()


def write_synthetic_dataset(path, spec: DatasetSpec, num_examples, *,
                            image_size=64, seed=0, frames_per_video=4,
                            class_signal=0.0, num_distinct_classes=None,
                            encode_jpeg: Callable[[np.ndarray], bytes]
                            = _cv2_encode_jpeg):
    """Write a small synthetic TFRecord split.  Labels, ``multi_hot``,
    ``anno``, keypoints, visibility and the images' pixels come from the
    same numpy generator in the same order as in the JAX package's
    function; the JPEG bytes come from ``encode_jpeg(image) -> bytes``
    (OpenCV by default, imported only then; the JAX package uses
    ``tf.io.encode_jpeg``).

    ``class_signal`` in [0, 1] blends a class-determined color pattern into
    the noise image; ``num_distinct_classes`` restricts labels to a
    subset."""
    rng = np.random.default_rng(seed)
    n_cls = num_distinct_classes or spec.num_classes

    def class_image(label):
        noise = rng.integers(0, 255, (image_size, image_size, 3))
        if not class_signal:
            return noise.astype(np.uint8)
        crng = np.random.default_rng(label)
        color = crng.integers(0, 255, (1, 1, 3))
        yy = np.linspace(0, 1, image_size)[:, None, None]
        pattern = color * (0.5 + 0.5 * np.sin(
            2 * np.pi * (crng.uniform(1, 3) * yy + crng.uniform())))
        img = (1 - class_signal) * noise + class_signal * pattern
        return np.clip(img, 0, 255).astype(np.uint8)

    examples = []
    for i in range(num_examples):
        kw = dict(height=image_size, width=image_size)
        if spec.multi_label:
            mh = (rng.random(spec.num_classes) > 0.8).astype(np.int64)
            first = int(rng.integers(n_cls))
            mh[first] = 1
            kw["multi_hot"] = mh
            kw["anno"] = np.where(mh > 0, 1,
                                  np.where(rng.random(spec.num_classes) > 0.5,
                                           -1, 0)).astype(np.int64)
            label_for_img = first
        else:
            if spec.is_video:
                vrng = np.random.default_rng(seed * 100003 +
                                             i // frames_per_video)
                kw["label"] = int(vrng.integers(n_cls))
            else:
                kw["label"] = int(rng.integers(n_cls))
            label_for_img = kw["label"]
        jpeg = encode_jpeg(class_image(label_for_img))
        if spec.has_pose:
            kw["keypoints"] = rng.uniform(
                0, image_size, (spec.num_joints, 2)).astype(np.float32)
            kw["visibility"] = (
                rng.random(spec.num_joints) > 0.2).astype(np.float32)
        if spec.is_video:
            kw["video_id"] = i // frames_per_video
            kw["frame"] = i % frames_per_video
        examples.append(make_example(jpeg, **kw))
    write_tfrecord(path, examples)
    return path
