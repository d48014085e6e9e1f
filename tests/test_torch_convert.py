"""The port's dataset converters (``data/convert_mpii.py``,
``convert_hico.py``, ``convert_hmdb.py``) against the JAX package's, on
the same JPEGs, annotations and videos.

Shards are compared byte for byte.  TensorFlow writes an example's
feature map in an order that changes from process to process (its
protobuf runtime seeds the map's hash per process), so each JAX record is
first brought to protobuf's deterministic form
(``SerializeToString(deterministic=True)``, the keys in order), which is
the form the port writes; the framing, the shard layout and every other
byte are JAX's own.  HMDB frames are encoded by TensorFlow's encoder where
bytes are compared, and by the port's default (OpenCV) within the decode
gate (mean |d| <= 1.5 levels) otherwise.  Small: 40x50 JPEGs and 32x24
videos, as the JAX package's ``tests/test_convert_scripts.py``.
"""

import os
from types import SimpleNamespace as NS

import cv2
import numpy as np
import pytest
import scipy.io
import tensorflow as tf
import torch

from attentionalpoolingaction_torch.data import convert_hico, convert_hmdb
from attentionalpoolingaction_torch.data import convert_mpii
from attentionalpoolingaction_torch.data import grain_pipeline, jpeg
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_tpu.data import convert_hico as jax_hico
from attentionalpoolingaction_tpu.data import convert_hmdb as jax_hmdb
from attentionalpoolingaction_tpu.data import convert_mpii as jax_mpii
from attentionalpoolingaction_tpu.data import records as jax_records

from test_torch_jpeg_kernel import with_exif_orientation

torch.set_num_threads(2)

DECODE_MEAN_LEVELS = 1.5


def canonical_shard(path) -> bytes:
    """A TFRecord file of the JAX package with each record in protobuf's
    deterministic form, framed again."""
    out = bytearray()

    class Buf:
        def write(self, b):
            out.extend(b)

    for raw in jax_records.read_tfrecord(str(path)):
        records.write_framed(Buf(), tf.train.Example.FromString(
            raw).SerializeToString(deterministic=True))
    return bytes(out)


def assert_shards_equal(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert names and sorted(os.listdir(port_dir)) == names
    for name in names:
        assert (port_dir / name).read_bytes() == \
            canonical_shard(jax_dir / name), name


def tf_jpeg(arr, quality=95):
    return tf.io.encode_jpeg(arr, quality=quality).numpy()


def smooth_image(rng, h, w):
    """A JPEG-friendly RGB image: a colour ramp plus mild noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 200 / h, xx * 200 / w, (yy + xx) * 100 / (h + w)],
                    -1)
    return np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(
        np.uint8)


def fake_release(names):
    """A RELEASE struct shaped as ``scipy.io.loadmat(squeeze_me=True,
    struct_as_record=False)`` gives it (the JAX test's ``fake_release``,
    one image a name): sparse act_ids, an image with no person, one
    unlabeled and one test image."""
    def person(y, x):
        pts = [NS(id=j, x=x + j, y=y + j, is_visible=j % 2)
               for j in (0, 5, 9, 15)]
        return NS(annopoints=NS(point=np.array(pts, dtype=object)))

    acts = [5, 101, 5, -1, 7, 101]
    annolist, act = [], []
    for i, name in enumerate(names):
        rect = (np.array([], dtype=object) if i == 2
                else person(10.0 + i, 20.0 + i))
        annolist.append(NS(image=NS(name=name), annorect=rect))
        act.append(NS(act_id=acts[i % len(acts)]))
    return NS(annolist=np.array(annolist, dtype=object),
              act=np.array(act, dtype=object),
              img_train=np.array([0 if i == 4 else 1
                                  for i in range(len(names))]))


@pytest.fixture
def mpii_images(tmp_path):
    """Six 40x50 JPEGs by TensorFlow's encoder, im3.jpg under EXIF
    orientation 6 (displayed 50x40; its frame header says 40x50)."""
    d = tmp_path / "images"
    d.mkdir()
    rng = np.random.default_rng(0)
    names = [f"im{i}.jpg" for i in range(6)]
    for i, name in enumerate(names):
        data = tf_jpeg(smooth_image(rng, 40, 50))
        if i == 3:
            data = with_exif_orientation(data, 6, b"II")
            assert jpeg.image_size(data) == (50, 40)
        (d / name).write_bytes(data)
    return d, names


def test_mpii_pure_functions_match_jax(mpii_images):
    _, names = mpii_images
    release = fake_release(names)
    got = convert_mpii.parse_mpii_mat(release)
    want = jax_mpii.parse_mpii_mat(release)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
            else:
                assert g[k] == w[k], k
    assert (convert_mpii.build_label_map(got)
            == jax_mpii.build_label_map(want) == {5: 0, 7: 1, 101: 2})
    split_names = [f"im{i:04d}.jpg" for i in range(500)] + names
    for frac in (0.0, 0.315, 1.0):
        assert [convert_mpii.assign_split(n, frac) for n in split_names] \
            == [jax_mpii.assign_split(n, frac) for n in split_names]


def test_mpii_shards_byte_equal_jax(mpii_images, tmp_path):
    images_dir, names = mpii_images
    entries = convert_mpii.parse_mpii_mat(fake_release(names))
    label_map = convert_mpii.build_label_map(entries)
    labeled = [e for e in entries if e["is_train"]]
    n = convert_mpii.write_records(labeled, str(images_dir),
                                   str(tmp_path / "port"), split="train",
                                   label_map=label_map, shards=2)
    want = jax_mpii.write_records(labeled, str(images_dir),
                                  str(tmp_path / "jax"), split="train",
                                  label_map=label_map, shards=2)
    assert n == want == 4        # im3 has no label, im4 is a test image
    assert_shards_equal(tmp_path / "port", tmp_path / "jax")
    # the oriented JPEG's record holds its frame header's size, as
    # tf.io.extract_jpeg_shape reads it
    spec = get_dataset("mpii")
    shapes = {}
    for shard in sorted((tmp_path / "port").iterdir()):
        for raw in records.read_tfrecord(str(shard)):
            feats = records.decode_example(raw)
            data = feats["image/encoded"][0]
            shapes[data] = (int(feats["image/height"][0]),
                            int(feats["image/width"][0]))
            assert shapes[data] == tuple(
                tf.io.extract_jpeg_shape(data).numpy()[:2])
            assert records.parse_example(raw, spec)["keypoints"].shape == (
                16, 2)
    oriented = (images_dir / "im3.jpg").read_bytes()
    assert oriented not in shapes       # unlabeled: skipped
    entries[3]["act_id"] = 5
    convert_mpii.write_records([entries[3]], str(images_dir),
                               str(tmp_path / "port3"), split="train",
                               label_map=label_map, shards=1)
    jax_mpii.write_records([entries[3]], str(images_dir),
                           str(tmp_path / "jax3"), split="train",
                           label_map=label_map, shards=1)
    assert_shards_equal(tmp_path / "port3", tmp_path / "jax3")
    (raw,) = records.read_tfrecord(
        str(tmp_path / "port3" / "train-00000-of-00001.tfrecord"))
    feats = records.decode_example(raw)
    assert (int(feats["image/height"][0]),
            int(feats["image/width"][0])) == (40, 50)


def test_mpii_records_feed_the_pipeline(mpii_images, tmp_path):
    images_dir, names = mpii_images
    entries = convert_mpii.parse_mpii_mat(fake_release(names))
    label_map = convert_mpii.build_label_map(entries)
    entries[3]["act_id"] = 7                    # the oriented JPEG
    labeled = [e for e in entries if e["is_train"]]
    assert convert_mpii.write_records(
        labeled, str(images_dir), str(tmp_path / "recs"), split="train",
        label_map=label_map, shards=2) == 5
    spec = get_dataset("mpii")
    batch = next(grain_pipeline.make_train_iterator(
        str(tmp_path / "recs" / "train-*.tfrecord"), spec, batch_size=5,
        image_size=32, resize_min=36, resize_max=40, device="cpu"))
    assert tuple(batch["image"].shape) == (5, 32, 32, 3)
    assert sorted(np.asarray(batch["label"]).tolist()) == [0, 0, 1, 2, 2]
    (ev,) = list(grain_pipeline.make_eval_dataset(
        str(tmp_path / "recs" / "train-*.tfrecord"), spec, batch_size=8,
        image_size=32, resize_min=36, device="cpu"))
    assert int(np.asarray(ev["mask"]).sum()) == 5


def write_mpii_mat(path, names, acts, img_train):
    """An MPII-shaped ``.mat``: ``RELEASE.annolist`` (``image.name``,
    ``annorect.annopoints.point`` with ``id/x/y/is_visible``; image 1
    has no person), ``RELEASE.act.act_id`` and ``RELEASE.img_train``."""
    def struct_array(fields, rows):
        a = np.zeros((1, len(rows)), dtype=[(f, "O") for f in fields])
        for i, row in enumerate(rows):
            for f in fields:
                a[0, i][f] = row[f]
        return a

    annolist = []
    for i, name in enumerate(names):
        points = struct_array(("id", "x", "y", "is_visible"), [
            {"id": j, "x": 3.0 * j + i, "y": 2.0 * j + i,
             "is_visible": j % 2} for j in (0, 3, 8, 12)])
        rect = (np.zeros((0, 0)) if i == 1 else struct_array(
            ("annopoints",), [{"annopoints": {"point": points}}]))
        annolist.append({"image": {"name": name}, "annorect": rect})
    release = {
        "annolist": struct_array(("image", "annorect"), annolist),
        "act": struct_array(("act_id",), [{"act_id": a} for a in acts]),
        "img_train": np.asarray(img_train, np.float64)[None]}
    scipy.io.savemat(str(path), {"RELEASE": release})


def test_mpii_main_takes_jax_flags(mpii_images, tmp_path):
    """``main`` with the JAX package's flags over a ``.mat`` gives JAX's
    records for both splits (the val split carved from labeled images)."""
    images_dir, names = mpii_images
    mat = tmp_path / "release.mat"
    write_mpii_mat(mat, names, [5, 101, 5, 7, 7, 101], [1, 1, 1, 1, 0, 1])
    args = convert_mpii.parse_args(["--mat", "m", "--images_dir", "i",
                                    "--out_dir", "o"])
    assert (args.shards, args.val_fraction) == (32, 0.315)
    counts = convert_mpii.main([
        "--mat", str(mat), "--images_dir", str(images_dir), "--out_dir",
        str(tmp_path / "port"), "--shards", "2", "--val_fraction", "0.5"])
    release = scipy.io.loadmat(str(mat), squeeze_me=True,
                               struct_as_record=False)["RELEASE"]
    entries = jax_mpii.parse_mpii_mat(release)
    assert [e["image_name"] for e in entries] == names
    assert entries[1]["keypoints"] is None
    np.testing.assert_array_equal(entries[0]["keypoints"][3], [6.0, 9.0])
    label_map = jax_mpii.build_label_map(entries)
    labeled = [e for e in entries if e["is_train"]]
    for split in ("train", "val"):
        want = jax_mpii.write_records(
            [e for e in labeled
             if jax_mpii.assign_split(e["image_name"], 0.5) == split],
            str(images_dir), str(tmp_path / "jax"), split=split,
            label_map=label_map, shards=2)
        assert counts[split] == want
    assert sum(counts.values()) == 5
    assert_shards_equal(tmp_path / "port", tmp_path / "jax")


def hico_fixture(tmp_path, n=4):
    d = tmp_path / "hico"
    rng = np.random.default_rng(1)
    names = []
    for split in ("train2015", "test2015"):
        (d / split).mkdir(parents=True)
        for i in range(n):
            name = f"HICO_{split}_{i:08d}.jpg"
            data = tf_jpeg(smooth_image(rng, 40, 50))
            if i == 1:
                data = with_exif_orientation(data, 6, b"MM")
            (d / split / name).write_bytes(data)
            names.append(name)
    anno = rng.choice([1.0, -1.0, 0.0, np.nan], (600, 2 * n))
    return d, names, anno


def test_hico_matches_jax(tmp_path):
    col = np.array([1, -1, 0, np.nan, 1])
    np.testing.assert_array_equal(convert_hico.anno_to_multi_hot(col),
                                  jax_hico.anno_to_multi_hot(col))
    np.testing.assert_array_equal(convert_hico.anno_to_known(col),
                                  jax_hico.anno_to_known(col))
    assert convert_hico.NUM_HOI_CLASSES == jax_hico.NUM_HOI_CLASSES
    d, names, anno = hico_fixture(tmp_path)
    for pkg, out in ((convert_hico, "port"), (jax_hico, "jax")):
        assert pkg.write_records(names[:4], anno[:, :4], str(d / "train2015"),
                                 str(tmp_path / out), split="train",
                                 shards=3) == 4
    assert_shards_equal(tmp_path / "port", tmp_path / "jax")

    # main over an anno.mat with JAX's flags, both splits
    mat = tmp_path / "anno.mat"
    scipy.io.savemat(str(mat), {
        "list_train": np.array(names[:4], dtype=object)[:, None],
        "anno_train": anno[:, :4],
        "list_test": np.array(names[4:], dtype=object)[:, None],
        "anno_test": anno[:, 4:]})
    args = convert_hico.parse_args(["--mat", "m", "--images_dir", "i",
                                    "--out_dir", "o"])
    assert args.shards == 32
    counts = convert_hico.main(["--mat", str(mat), "--images_dir", str(d),
                                "--out_dir", str(tmp_path / "main"),
                                "--shards", "3"])
    assert counts == {"train": 4, "test": 4}
    jax_hico.write_records(names[4:], anno[:, 4:], str(d / "test2015"),
                           str(tmp_path / "jax"), split="test", shards=3)
    assert_shards_equal(tmp_path / "main", tmp_path / "jax")
    spec = get_dataset("hico")
    (batch,) = list(grain_pipeline.make_eval_dataset(
        str(tmp_path / "main" / "test-*.tfrecord"), spec, batch_size=4,
        image_size=24, resize_min=28, device="cpu"))
    want = (np.nan_to_num(anno[:, 4:]) > 0).T.astype(np.float32)
    got = np.asarray(batch["label"])
    assert got.shape == (4, 600)
    # one pass in file order: shard 0 holds items 0 and 3
    order = [0, 3, 1, 2]
    np.testing.assert_array_equal(got, want[order])
    scipy.io.savemat(str(mat), {"list_train": np.array(["a.jpg"], object),
                                "anno_train": np.zeros((599, 1)),
                                "list_test": np.array(["a.jpg"], object),
                                "anno_test": np.zeros((599, 1))})
    with pytest.raises(ValueError, match="600 classes"):
        convert_hico.main(["--mat", str(mat), "--images_dir", str(d),
                           "--out_dir", str(tmp_path / "bad")])


def write_video(path, frames):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                        (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()


@pytest.fixture
def hmdb_videos(tmp_path):
    rng = np.random.default_rng(2)
    root = tmp_path / "videos"
    items = []
    for v, cls in enumerate(("run", "walk", "run")):
        (root / cls).mkdir(parents=True, exist_ok=True)
        path = root / cls / f"v{v}.avi"
        write_video(path, [smooth_image(rng, 24, 32) for _ in range(9 + v)])
        items.append((v, 3 + v, str(path)))
    return root, items


def test_hmdb_pure_functions_match_jax(tmp_path):
    for n, k in ((100, 5), (3, 10), (0, 10), (25, 25), (7, 3)):
        np.testing.assert_array_equal(
            convert_hmdb.sample_frame_indices(n, k),
            jax_hmdb.sample_frame_indices(n, k))
    d = tmp_path / "splits"
    d.mkdir()
    (d / "run_test_split1.txt").write_text("a.avi 1\nb.avi 2\nc.avi 0\n\n")
    (d / "walk_test_split1.txt").write_text("d.avi 1\n")
    (d / "walk_test_split2.txt").write_text("e.avi 2\n")
    for split_id in (1, 2):
        assert (convert_hmdb.read_split_files(str(d), split_id)
                == jax_hmdb.read_split_files(str(d), split_id))


def test_hmdb_shards_byte_equal_jax_given_its_encoder(hmdb_videos,
                                                      tmp_path):
    _, items = hmdb_videos
    for a, b in zip(convert_hmdb.extract_frames(items[1][2], 4),
                    jax_hmdb.extract_frames(items[1][2], 4)):
        np.testing.assert_array_equal(a, b)
    n = convert_hmdb.write_records(
        items, str(tmp_path / "port"), split="train", frames_per_video=4,
        shards=2, encode_jpeg=lambda f: tf_jpeg(f, quality=90))
    want = jax_hmdb.write_records(items, str(tmp_path / "jax"),
                                  split="train", frames_per_video=4,
                                  shards=2)
    assert n == want == 12
    assert_shards_equal(tmp_path / "port", tmp_path / "jax")


def test_hmdb_opencv_encoder_within_the_decode_gate(hmdb_videos, tmp_path):
    """The default encoder (OpenCV at quality 90): the frames decode within
    the decode gate of TensorFlow's, the other features equal; the
    records feed the port's eval pipeline, a video's frames in one
    shard."""
    _, items = hmdb_videos
    convert_hmdb.write_records(items, str(tmp_path / "port"), split="test",
                               frames_per_video=4, shards=2)
    jax_hmdb.write_records(items, str(tmp_path / "jax"), split="test",
                           frames_per_video=4, shards=2)
    for name in sorted(os.listdir(tmp_path / "jax")):
        port = list(records.read_tfrecord(str(tmp_path / "port" / name)))
        want = list(jax_records.read_tfrecord(str(tmp_path / "jax" / name)))
        assert len(port) == len(want)
        for p, j in zip(port, want):
            pf, jf = records.decode_example(p), records.decode_example(j)
            assert pf.keys() == jf.keys()
            for k in pf:
                if k != "image/encoded":
                    np.testing.assert_array_equal(pf[k], jf[k])
            got = cv2.imdecode(np.frombuffer(pf["image/encoded"][0],
                                             np.uint8), cv2.IMREAD_COLOR)
            ref = cv2.imdecode(np.frombuffer(jf["image/encoded"][0],
                                             np.uint8), cv2.IMREAD_COLOR)
            gap = np.abs(got.astype(np.int16) - ref).mean()
            assert gap <= DECODE_MEAN_LEVELS, (name, gap)
    spec = get_dataset("hmdb51")
    (batch,) = list(grain_pipeline.make_eval_dataset(
        str(tmp_path / "port" / "test-*.tfrecord"), spec, batch_size=12,
        image_size=16, resize_min=20, device="cpu"))
    assert np.asarray(batch["video_id"]).tolist() == [0] * 4 + [2] * 4 + [
        1] * 4
    assert np.asarray(batch["label"]).tolist() == [3] * 4 + [5] * 4 + [
        4] * 4


def test_hmdb_main_takes_jax_flags(hmdb_videos, tmp_path, monkeypatch):
    root, _ = hmdb_videos
    splits = tmp_path / "splits"
    splits.mkdir()
    (splits / "run_test_split1.txt").write_text("v0.avi 1\nv2.avi 2\n")
    (splits / "walk_test_split1.txt").write_text("v1.avi 1\n")
    args = convert_hmdb.parse_args(["--videos_dir", "v", "--splits_dir",
                                    "s", "--out_dir", "o"])
    assert (args.split_id, args.frames_per_video, args.shards) == (1, 25, 32)
    counts = convert_hmdb.main([
        "--videos_dir", str(root), "--splits_dir", str(splits), "--out_dir",
        str(tmp_path / "recs"), "--frames_per_video", "3", "--shards", "2"])
    assert counts == {"train": 6, "test": 3}


def test_hmdb_without_opencv_fails_as_jax(monkeypatch, tmp_path):
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    for pkg in (convert_hmdb, jax_hmdb):
        with pytest.raises(ModuleNotFoundError, match="cv2"):
            pkg.extract_frames(str(tmp_path / "v.avi"), 4)
    with pytest.raises(ModuleNotFoundError, match="cv2"):
        convert_hmdb.write_records(
            [(0, 0, str(tmp_path / "v.avi"))], str(tmp_path / "r"),
            split="train", shards=1, encode_jpeg=tf_jpeg)


def test_hmdb_conversion_streams_bounded(tmp_path, monkeypatch):
    """The JAX package's streaming invariant: when a record of video v is
    written, only videos 0..v have been decoded; 300 videos, and every
    video's frames in one shard."""
    extracted = []

    def fake_extract(path, n):
        extracted.append(path)
        rng = np.random.default_rng(len(extracted))
        return [rng.integers(0, 255, (24, 24, 3), np.uint8)
                for _ in range(2)]

    monkeypatch.setattr(convert_hmdb, "extract_frames", fake_extract)

    class InstrumentedWriter(records.ShardedTFRecordWriter):
        def write(self, data, shard=None):
            video_of_write = self.count // 2
            assert len(extracted) == video_of_write + 1, (
                f"buffering: wrote video {video_of_write} after "
                f"extracting {len(extracted)}")
            super().write(data, shard=shard)

    out = tmp_path / "recs"
    items = [(i, i % 51, f"v{i}.avi") for i in range(300)]
    n = convert_hmdb.write_records(
        items, str(out), split="train", frames_per_video=2, shards=8,
        writer_cls=InstrumentedWriter, encode_jpeg=lambda f: b"\xff\xd8")
    assert n == 600 and len(extracted) == 300
    shards_of = {}
    for s in range(8):
        for raw in records.read_tfrecord(
                str(out / f"train-{s:05d}-of-00008.tfrecord")):
            vid = int(records.decode_example(raw)["video/id"][0])
            shards_of.setdefault(vid, set()).add(s)
    assert len(shards_of) == 300
    assert all(s == {v % 8} for v, s in shards_of.items())
