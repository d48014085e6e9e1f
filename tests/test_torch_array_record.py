"""The port's ArrayRecord codec (``csrc/array_record.cc``,
``data/array_record.py``, ``data/zstd.py``) against the JAX package's
writer and Grain's readers, and the paths built on it: ``make_source``,
``reformat``, the train and eval datasets, the video index and the CLIs.

  * files that the JAX package's ``write_array_record`` writes (records of
    0 B to 200 KB, group sizes 1 and 3, 2,000 small records) read back
    record for record with every hash verified, and the port's
    HighwayHash gives every block-header, chunk-header and data hash in
    them (walked here independently of the C++ reader);
  * files that the port writes read back through Grain's
    ``ArrayRecordDataSource`` and ``ArrayRecordReader``, which report the
    JAX writer's options string;
  * a corrupt byte, a truncated file, refused options and a missing
    ``libzstd.so.1`` raise.

All exact: records are compared as bytes, losses and batches for
equality.
"""

import os
import pickle
import shutil
import struct
import tempfile
from unittest import mock

import numpy as np
import pytest
from array_record.python.array_record_module import (
    ArrayRecordReader,
    ArrayRecordWriter,
)
from grain.sources import ArrayRecordDataSource as GrainArrayRecordSource

from attentionalpoolingaction_torch import eval_cli, train_cli
from attentionalpoolingaction_torch.data import array_record as ar
from attentionalpoolingaction_torch.data import grain_pipeline as gp
from attentionalpoolingaction_torch.data import native_io, records, zstd
from attentionalpoolingaction_torch.data import reformat
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_tpu.data import records as jax_records
from attentionalpoolingaction_tpu.data import reformat as jax_reformat

from test_torch_cli import SMALL, scalars

BLOCK = 1 << 16


def payloads(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, np.uint8).tobytes() for n in sizes]


# name: (records, group size)
CASES = {
    "sizes_g1": (payloads([0, 1, 1000, 70000, 200000]), 1),
    "sizes_g3": (payloads([0, 1, 1000, 70000, 200000], seed=1), 3),
    "small_2000": ([b"r%d" % i for i in range(2000)], 1),
}


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ar")
    out = {}
    for name, (recs, group) in CASES.items():
        path = str(d / f"{name}.array_record")
        jax_records.write_array_record(path, recs, group_size=group)
        out[name] = path
    return out


def _logical(raw, pos, n):
    """n bytes of a chunk from ``pos``, block headers skipped; and the
    position after them."""
    out = bytearray()
    while len(out) < n:
        if pos % BLOCK == 0:
            pos += 24
        take = min(n - len(out), BLOCK - pos % BLOCK)
        out += raw[pos:pos + take]
        pos += take
    return bytes(out), pos


def stored_and_computed_hashes(raw):
    """(stored, computed) of every hash in a riegeli file: each block
    header's, then each chunk's header hash and data hash."""
    u64 = lambda b: struct.unpack("<Q", b[:8])[0]  # noqa: E731
    for b in range(0, len(raw), BLOCK):
        yield u64(raw[b:]), ar.highway_hash(raw[b + 8:b + 24])
    pos = 0
    while pos < len(raw):
        header, p = _logical(raw, pos, 40)
        data_size, data_hash, kind = struct.unpack("<QQQ", header[8:32])
        yield u64(header), ar.highway_hash(header[8:])
        data, p = _logical(raw, p, data_size)
        yield data_hash, ar.highway_hash(data)
        # a chunk of n records spans at least n bytes
        nxt = pos + (kind >> 8)
        if 0 < nxt % BLOCK < 24:
            nxt += 24 - nxt % BLOCK
        pos = max(p, nxt)


@pytest.mark.parametrize("name", list(CASES))
def test_port_reads_jax_files_and_their_hashes(jax_files, name):
    recs, group = CASES[name]
    f = ar.ArrayRecordFile(jax_files[name], verify_hash=True)
    assert len(f) == len(recs)
    assert [f[i] for i in range(len(f))] == recs
    assert f[-1] == recs[-1]
    with pytest.raises(IndexError):
        f[len(recs)]
    assert f.writer_options == ar.writer_options(group)
    raw = open(jax_files[name], "rb").read()
    pairs = list(stored_and_computed_hashes(raw))
    assert len(pairs) >= len(raw) // BLOCK + 2 * (len(recs) // group + 4)
    assert all(stored == computed for stored, computed in pairs)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_reads_port_files(tmp_path, name):
    recs, group = CASES[name]
    path = str(tmp_path / "port.array_record")
    records.write_array_record(path, recs, group_size=group)
    reader = ArrayRecordReader(path)
    assert reader.writer_options_string() == ar.writer_options(group)
    assert [bytes(r) for r in reader.read_all()] == recs
    src = GrainArrayRecordSource([path])
    assert len(src) == len(recs)
    assert [bytes(src[i]) for i in range(len(src))] == recs
    raw = open(path, "rb").read()
    assert len(raw) % BLOCK == 0
    assert all(s == c for s, c in stored_and_computed_hashes(raw))


def test_small_file_byte_equal_to_jax(tmp_path):
    """Where zstd gives the same frames (small records), the port's file is
    the JAX writer's byte for byte."""
    recs = [b"a" * 10, b"b" * 11, b"c" * 12]
    jax_records.write_array_record(str(tmp_path / "j.ar"), recs)
    ar.write_array_record_file(str(tmp_path / "p.ar"), recs)
    assert (tmp_path / "p.ar").read_bytes() == \
        (tmp_path / "j.ar").read_bytes()


def test_reformat_round_trips_and_crosses_packages(tmp_path):
    spec = get_dataset("mpii")
    src = str(tmp_path / "train-00000-of-00001.tfrecord")
    records.write_synthetic_dataset(src, spec, 6, image_size=48)
    for sub in ("port_ar", "back", "jax_back", "jax_ar", "port_back"):
        os.makedirs(tmp_path / sub)
    port_ar = reformat.reformat_file(src, str(tmp_path / "port_ar"))
    assert port_ar.endswith("train-00000-of-00001.array_record")
    back = reformat.reformat_file(port_ar, str(tmp_path / "back"))
    assert open(back, "rb").read() == open(src, "rb").read()
    # JAX's converter reads the port's ArrayRecord, the port's reads JAX's
    jax_back = jax_reformat.reformat_file(port_ar, str(tmp_path / "jax_back"))
    assert open(jax_back, "rb").read() == open(src, "rb").read()
    jax_ar = jax_reformat.reformat_file(src, str(tmp_path / "jax_ar"))
    port_back = reformat.reformat_file(jax_ar, str(tmp_path / "port_back"))
    assert open(port_back, "rb").read() == open(src, "rb").read()
    # the CLI
    reformat.main(["--src", str(tmp_path / "*.tfrecord"),
                   "--dst_dir", str(tmp_path / "cli")])
    assert ar.ArrayRecordFile(
        str(tmp_path / "cli" / "train-00000-of-00001.array_record"))[0] == \
        next(records.read_tfrecord(src))


def test_make_source(tmp_path):
    a, b = payloads([5, 6, 7]), payloads([8, 9], seed=1)
    pa, pb = str(tmp_path / "a.array_record"), str(tmp_path / "b.arrayrecord")
    records.write_array_record(pa, a)
    jax_records.write_array_record(pb, b)
    src = native_io.make_source([pa, pb])
    assert isinstance(src, native_io.ArrayRecordDataSource)
    assert not hasattr(src, "files")
    assert len(src) == 5
    assert [src[i] for i in range(5)] == a + b
    assert src[-1] == b[-1] and src[-3] == a[-1]
    with pytest.raises(IndexError):
        src[5]
    assert len(native_io.make_source(str(tmp_path / "a.array_record"))) == 3
    # picklable: the files reopen lazily, as the indexed TFRecord files do
    again = pickle.loads(pickle.dumps(native_io.make_source(
        [pa, pb], verify_crc=True)))
    assert [again[i] for i in range(5)] == a + b
    tfr = str(tmp_path / "c.tfrecord")
    records.write_tfrecord(tfr, a)
    assert isinstance(native_io.make_source(tfr),
                      native_io.TFRecordDataSource)
    with pytest.raises(ValueError, match="mixed record formats"):
        native_io.make_source([pa, tfr])


def test_datasets_equal_from_both_formats(tmp_path):
    spec = get_dataset("mpii")
    tfr = str(tmp_path / "m.tfrecord")
    records.write_synthetic_dataset(tfr, spec, 7, image_size=48)
    arp = str(tmp_path / "m.array_record")
    records.write_array_record(arp, records.read_tfrecord(tfr))
    kw = dict(batch_size=3, image_size=32, resize_min=40, seed=5,
              device="cpu")
    it_t, it_a = (iter(gp.make_train_dataset(p, spec, **kw))
                  for p in (tfr, arp))
    for _ in range(3):     # past the first epoch
        bt, ba = next(it_t), next(it_a)
        assert set(bt) == set(ba)
        for k in bt:
            np.testing.assert_array_equal(bt[k], ba[k])
    ev = [list(gp.make_eval_dataset(p, spec, batch_size=4, image_size=32,
                                    resize_min=40, device="cpu"))
          for p in (tfr, arp)]
    assert len(ev[0]) == len(ev[1]) == 2
    for bt, ba in zip(*ev):
        for k in bt:
            np.testing.assert_array_equal(bt[k], ba[k])
    hmdb = get_dataset("hmdb51")
    vt = str(tmp_path / "v.tfrecord")
    records.write_synthetic_dataset(vt, hmdb, 9, image_size=32,
                                    frames_per_video=3)
    va = str(tmp_path / "v.array_record")
    records.write_array_record(va, records.read_tfrecord(vt))
    index = gp.build_video_index(native_io.make_source(va), hmdb)
    assert index == gp.build_video_index(native_io.make_source(vt), hmdb)
    assert index == {0: [0, 1, 2], 1: [3, 4, 5], 2: [6, 7, 8]}


def test_corrupt_and_truncated_files_raise(tmp_path):
    path = str(tmp_path / "c.array_record")
    recs = payloads([3000, 100000])
    records.write_array_record(path, recs)
    raw = bytearray(open(path, "rb").read())
    flipped = bytearray(raw)
    flipped[64 + 40 + 2000] ^= 0x5A        # inside the first record's data
    bad = str(tmp_path / "flipped.array_record")
    open(bad, "wb").write(bytes(flipped))
    with pytest.raises(ValueError, match="data hash"):
        ar.ArrayRecordFile(bad, verify_hash=True)[0]
    assert ar.ArrayRecordFile(bad, verify_hash=True)[1] == recs[1]
    block = bytearray(raw)
    block[BLOCK + 12] ^= 1                 # a block header's link
    open(bad, "wb").write(bytes(block))
    with pytest.raises(ValueError, match="block header hash"):
        ar.ArrayRecordFile(bad)[1]
    for size in (len(raw) - 1000, len(raw) - BLOCK, 100):
        open(bad, "wb").write(bytes(raw[:size]))
        with pytest.raises(ValueError, match="truncated"):
            ar.ArrayRecordFile(bad)


@pytest.mark.parametrize("options,refused", [
    ("group_size:1,transpose:true", "transpose:true"),
    ("group_size:1,brotli:6", "brotli"),
])
def test_unsupported_options_raise(tmp_path, options, refused):
    path = str(tmp_path / "t.array_record")
    w = ArrayRecordWriter(path, options)
    w.write(b"x" * 10)
    w.close()
    with pytest.raises(NotImplementedError, match=refused):
        ar.ArrayRecordFile(path)


def test_uncompressed_file_reads_and_missing_libzstd_raises(tmp_path):
    path = str(tmp_path / "u.array_record")
    w = ArrayRecordWriter(path, "group_size:2,uncompressed")
    for r in payloads([10, 0, 30]):
        w.write(r)
    w.close()
    f = ar.ArrayRecordFile(path, verify_hash=True)
    assert [f[i] for i in range(3)] == payloads([10, 0, 30])

    def no_zstd(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    zpath = str(tmp_path / "z.array_record")
    records.write_array_record(zpath, [b"x"])
    with mock.patch.object(zstd, "_lib", None), \
            mock.patch.object(zstd.ctypes, "CDLL", no_zstd):
        # the uncompressed file needs no zstd; a zstd chunk raises
        assert ar.ArrayRecordFile(path)[2] == payloads([10, 0, 30])[2]
        with pytest.raises(OSError, match=r"libzstd\.so\.1"):
            ar.ArrayRecordFile(zpath)
        with pytest.raises(OSError, match=r"libzstd\.so\.1"):
            records.write_array_record(str(tmp_path / "w.array_record"),
                                       [b"x"])


def test_clis_from_array_record_equal_tfrecord():
    with tempfile.TemporaryDirectory() as d:
        spec = get_dataset("mpii")
        for split, n, seed in (("train", 8, 0), ("val", 3, 1)):
            tfr = f"{d}/{split}.tfrecord"
            records.write_synthetic_dataset(tfr, spec, n, image_size=80,
                                            seed=seed)
            records.write_array_record(f"{d}/{split}.array_record",
                                       records.read_tfrecord(tfr))
        results = {}
        for ext in ("tfrecord", "array_record"):
            run = f"{d}/run_{ext}"
            state = train_cli.main([
                "--config", "mpii_rank1_224", "--train_pattern",
                f"{d}/train.{ext}", "--workdir", run, "--num_steps", "2",
                *SMALL])
            assert state.step == 2
            printed = eval_cli.main([
                "--config", "mpii_rank1_224", "--workdir", run, "--notb",
                "--eval_pattern", f"{d}/val.{ext}", *SMALL])
            results[ext] = (scalars(run)["loss/total"], printed)
        losses, evals = results["array_record"]
        assert len(losses) == 2
        assert results["tfrecord"] == (losses, evals)
        assert evals[0]["num_examples"] == 3
        shutil.rmtree(d, ignore_errors=True)
