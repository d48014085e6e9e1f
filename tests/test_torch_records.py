"""The port's record layer against the JAX package's: TFRecord framing
byte for byte, the native ``.idx`` index byte for byte (each package reads
the other's), the hand-written ``tf.train.Example`` decoder against the
JAX ``grain_pipeline.parse_example`` on TF-written records, TF's parser on
the port's hand-written encoder, ``write_synthetic_dataset`` drawing as
the JAX one draws, the JPEG frame-header reader and the EXIF orientation
against OpenCV, and the hand-written TensorBoard event files through
TensorBoard's reader.

All exact: bytes, integers and float32 values are compared for equality.
"""

import os

import cv2
import numpy as np
import pytest
import tensorflow as tf
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import native_io
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.utils import metrics_writer
from attentionalpoolingaction_tpu.data import grain_pipeline as jax_gp
from attentionalpoolingaction_tpu.data import native_io as jax_native_io
from attentionalpoolingaction_tpu.data import preprocessing_np as jax_ppnp
from attentionalpoolingaction_tpu.data import records as jax_records

from test_torch_jpeg_kernel import with_exif_orientation

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_torch")


def payloads(n=17, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 300)),
                         np.uint8).tobytes() for _ in range(n)]


def test_native_crc_matches_python():
    for data in [b"", b"a", bytes(range(256)) * 3] + payloads(9):
        assert native_io.masked_crc32c(data) == records._masked_crc_py(data)
        assert records._crc32c(data) == jax_records._crc32c(data)


def test_framing_bytes_equal_jax(tmp_path):
    data = payloads()
    records.write_tfrecord(str(tmp_path / "port.tfrecord"), data)
    jax_records.write_tfrecord(str(tmp_path / "jax.tfrecord"), data)
    assert (tmp_path / "port.tfrecord").read_bytes() == \
        (tmp_path / "jax.tfrecord").read_bytes()
    assert list(records.read_tfrecord(str(tmp_path / "port.tfrecord"))) \
        == data
    with records.ShardedTFRecordWriter(str(tmp_path / "sh"), "train",
                                       3) as w:
        for d in data:
            w.write(d)
    got = [list(records.read_tfrecord(p)) for p in w.paths]
    assert got == [data[i::3] for i in range(3)] and w.count == len(data)
    records.write_array_record(str(tmp_path / "x.array_record"), data)
    got = native_io.make_source(str(tmp_path / "x.array_record"))
    assert [got[i] for i in range(len(got))] == data


def test_index_byte_equal_and_read_across_packages(tmp_path):
    data = payloads(23, seed=1)
    path = str(tmp_path / "d.tfrecord")
    records.write_tfrecord(path, data)
    assert native_io.build_index(path, path + ".port.idx") == 23
    assert jax_native_io.build_index(path, path + ".jax.idx") == 23
    port_idx = open(path + ".port.idx", "rb").read()
    assert port_idx == open(path + ".jax.idx", "rb").read()
    assert port_idx[:8] == b"10XDIRFT"     # "TFRIDX01", a little-endian u64
    # each package reads the other's index
    port = native_io.IndexedTFRecordFile(path, path + ".jax.idx",
                                         verify_crc=True)
    jax = jax_native_io.IndexedTFRecordFile(path, path + ".port.idx")
    assert [port[i] for i in range(len(port))] == data
    assert [jax[i] for i in range(len(jax))] == data
    assert port[-1] == data[-1]
    with pytest.raises(IndexError):
        port[23]
    src = native_io.make_source([path, path])
    assert len(src) == 46 and src[23] == data[0]
    records.write_array_record(str(tmp_path / "a.array_record"), data)
    src = native_io.make_source([str(tmp_path / "a.array_record")])
    assert isinstance(src, native_io.ArrayRecordDataSource)
    assert len(src) == 23 and src[-1] == data[-1]


def test_corrupt_record_detected(tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    records.write_tfrecord(path, [b"hello world" * 10])
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        native_io.build_index(path, verify_crc=True)


def assert_parsed_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        w = want[k]
        if isinstance(w, bytes):
            assert got[k] == w, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("name", ["mpii", "hico", "hmdb51"])
def test_parse_tf_written_examples_equals_jax(tmp_path, name):
    spec = get_dataset(name)
    path = str(tmp_path / "tf.tfrecord")
    jax_records.write_synthetic_dataset(path, spec, 5, image_size=16,
                                        seed=3, frames_per_video=2)
    for raw in jax_records.read_tfrecord(path):
        for anno in (False, True):
            assert_parsed_equal(
                records.parse_example(raw, spec, include_anno=anno),
                jax_gp.parse_example(raw, spec, include_anno=anno))


def test_parse_defaults_and_missing_fields():
    hico = get_dataset("hico")
    raw = jax_records.make_example(b"\xff\xd8", height=1, width=1,
                                   multi_hot=np.eye(600, dtype=np.int64)[3])
    for anno in (False, True):
        assert_parsed_equal(
            records.parse_example(raw, hico, include_anno=anno),
            jax_gp.parse_example(raw, hico, include_anno=anno))
    hmdb = get_dataset("hmdb51")
    raw = tf.train.Example(features=tf.train.Features(feature={
        "image/encoded": tf.train.Feature(
            bytes_list=tf.train.BytesList(value=[b"x"])),
        "image/class/label": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[7])),
        "video/id": tf.train.Feature(
            int64_list=tf.train.Int64List(value=[-2]))})
    ).SerializeToString()
    assert_parsed_equal(records.parse_example(raw, hmdb),
                        jax_gp.parse_example(raw, hmdb))
    bare = records.make_example(b"x", height=1, width=1)
    with pytest.raises(KeyError, match="image/class/label"):
        records.parse_example(bare, get_dataset("mpii"))


def test_tf_parses_port_make_example():
    rng = np.random.default_rng(0)
    kw = dict(height=720, width=1280, label=392,
              multi_hot=rng.integers(0, 2, 600),
              anno=rng.integers(-1, 2, 600),
              keypoints=rng.uniform(-5, 1300, (16, 2)).astype(np.float32),
              visibility=(rng.random(16) > 0.5).astype(np.float32),
              video_id=2 ** 40 + 1, frame=9)
    raw = records.make_example(b"\xff\xd8jpeg\x00bytes", **kw)
    feats = tf.train.Example.FromString(raw).features.feature
    assert feats["image/encoded"].bytes_list.value == [
        b"\xff\xd8jpeg\x00bytes"]
    for key, want in (("image/height", [720]), ("image/width", [1280]),
                      ("image/class/label", [392]),
                      ("image/class/multi_hot", kw["multi_hot"]),
                      ("image/class/anno", kw["anno"]),
                      ("video/id", [2 ** 40 + 1]), ("video/frame", [9])):
        assert list(feats[key].int64_list.value) == list(want), key
    np.testing.assert_array_equal(
        np.asarray(feats["image/pose/keypoints"].float_list.value,
                   np.float32), kw["keypoints"].reshape(-1))
    np.testing.assert_array_equal(
        np.asarray(feats["image/pose/visibility"].float_list.value,
                   np.float32), kw["visibility"])
    # and the port's decoder reads its own encoding back
    got = records.decode_example(raw)
    np.testing.assert_array_equal(got["image/class/anno"], kw["anno"])
    np.testing.assert_array_equal(got["image/pose/keypoints"],
                                  kw["keypoints"].reshape(-1))


@pytest.mark.parametrize("name, signal", [("mpii", 0.0), ("hico", 0.0),
                                          ("hmdb51", 0.5)])
def test_synthetic_dataset_draws_as_jax(tmp_path, name, signal):
    """With TF's JPEG encoder passed in, the port's records hold the same
    labels, annotations, keypoints and the same JPEG bytes as the JAX
    package's: the generator is drawn in the same order."""
    spec = get_dataset(name)
    kw = dict(image_size=24, seed=5, frames_per_video=3,
              class_signal=signal, num_distinct_classes=7)
    records.write_synthetic_dataset(
        str(tmp_path / "port.tfrecord"), spec, 6,
        encode_jpeg=lambda img: tf.io.encode_jpeg(img).numpy(), **kw)
    jax_records.write_synthetic_dataset(str(tmp_path / "jax.tfrecord"),
                                        spec, 6, **kw)
    port = list(records.read_tfrecord(str(tmp_path / "port.tfrecord")))
    jax = list(jax_records.read_tfrecord(str(tmp_path / "jax.tfrecord")))
    assert len(port) == len(jax) == 6
    for p, j in zip(port, jax):
        assert_parsed_equal(records.parse_example(p, spec, include_anno=True),
                            jax_gp.parse_example(j, spec, include_anno=True))


def test_default_encoder_is_opencv(tmp_path):
    spec = get_dataset("mpii")
    path = str(tmp_path / "cv2.tfrecord")
    records.write_synthetic_dataset(path, spec, 2, image_size=20, seed=1)
    for raw in records.read_tfrecord(path):
        data = records.parse_example(raw, spec)["image_bytes"]
        assert jpeg.image_size(data) == (20, 20)
        assert cv2.imdecode(np.frombuffer(data, np.uint8),
                            cv2.IMREAD_COLOR).shape == (20, 20, 3)


def test_jpeg_image_size_reads_the_frame_header():
    for name in sorted(os.listdir(FIXTURES)):
        if not name.endswith(".jpg"):
            continue
        data = open(os.path.join(FIXTURES, name), "rb").read()
        img = cv2.imdecode(np.frombuffer(data, np.uint8),
                           cv2.IMREAD_UNCHANGED)
        assert jpeg.image_size(data) == img.shape[:2], name
    progressive = cv2.imencode(
        ".jpg", np.zeros((37, 53, 3), np.uint8),
        [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    assert jpeg.image_size(progressive) == (37, 53)
    for bad in (b"", b"GIF89a", b"\xff\xd8\xff\xda\x00\x02"):
        with pytest.raises(ValueError):
            jpeg.image_size(bad)


@pytest.mark.parametrize("order", [b"II", b"MM"])
def test_exif_orientation_is_refused(order):
    """No EXIF orientation is refused: for 1-8, in both byte orders,
    ``image_size`` is the shape OpenCV decodes, ``decode(..., "cpu")``
    equals the JAX package's ``decode_jpeg`` bit for bit, ``orient``
    applied to the plain decode equals it too (what the card does after
    nvJPEG), and the geometry drawn from ``image_size`` equals the JAX
    pipeline's."""
    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3), np.uint8)
    data = cv2.imencode(".jpg", img)[1].tobytes()
    plain = jpeg.decode([data], "cpu")[0]
    for orientation in range(1, 9):
        oriented = with_exif_orientation(data, orientation, order)
        want = jax_ppnp.decode_jpeg(oriented)
        assert jpeg.image_size(oriented) == want.shape[:2]
        assert want.shape[:2] == ((40, 24) if orientation >= 5
                                  else (24, 40))
        np.testing.assert_array_equal(
            jpeg.decode([data, oriented], "cpu")[1].numpy(), want)
        np.testing.assert_array_equal(
            jpeg.orient(plain, orientation).numpy(), want)
        for seed in range(3):
            _, transform = jax_ppnp.preprocess_image_np(
                oriented, out_size=16, is_training=True, resize_min=20,
                resize_max=30, rng=np.random.default_rng(seed))
            g = pp.draw_geometry(*jpeg.image_size(oriented), out_size=16,
                                 is_training=True, resize_min=20,
                                 resize_max=30,
                                 rng=np.random.default_rng(seed))
            np.testing.assert_array_equal(g.transform(), transform)


def test_event_file_reads_back_through_tensorboard(tmp_path):
    writer = metrics_writer.make_writer(str(tmp_path))
    hook = metrics_writer.make_train_hook(writer, log_every=2)
    for step in (1, 2, 3, 4):
        hook(step, None, {"loss": torch.tensor(step / 10)})
    metrics_writer.write_eval(writer, 4, {"mAP": 0.25, "per_class": [1.0],
                                          "num_examples": 7})
    writer.close()
    second = metrics_writer.make_writer(str(tmp_path))
    second.write_scalars(5, {"loss": 0.5})
    second.close()
    assert second.path != writer.path
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == [
        "eval/mAP", "eval/num_examples", "loss"]
    got = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
           for tag in acc.Tags()["scalars"]}
    assert got["loss"] == [(2, pytest.approx(0.2)), (4, pytest.approx(0.4)),
                           (5, 0.5)]
    assert got["eval/mAP"] == [(4, 0.25)]
    assert got["eval/num_examples"] == [(4, 7.0)]
    assert metrics_writer.make_writer(str(tmp_path / "none"),
                                      just_logging=True).path is None
