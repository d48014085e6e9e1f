"""The port's input pipeline on the CPU against the JAX package's.

  * Geometry: ``draw_geometry`` and the ``transform`` equal
    ``preprocess_decoded_np``'s under the same seed, and the multicrop
    geometry ``eval_multicrop_np``'s, exactly.
  * Pixels: the port's CPU path (OpenCV decode, ``F.interpolate``) against
    the JAX pipeline's (OpenCV decode, ``cv2.resize``) on the JPEG
    fixtures: within 1 level, on at most 0.1% of the pixels (the two
    bilinear resamplers agree to a few thousandths of a level in float32
    on these scenes; rounding to uint8 turns that into 1 level where a
    value sits on .5).  Float32 crops of full-range uniform noise, the
    resamplers' worst case (OpenCV rounds its interpolation weights),
    within 0.05 of a level.
  * Eval batches against the JAX ``grain_pipeline.make_eval_dataset`` and
    ``make_multicrop_eval_dataset``: labels, mask, anno and transform
    exactly, images within 1 level.
  * Train stream properties: an epoch is a permutation of the (shard's)
    index, epochs differ, the same seed gives the same stream, shards
    partition the index, and a mid-epoch resume is bitwise the
    uninterrupted stream, with and without reader threads.
  * ``EchoIterator``, ``StatefulPrefetchIterator`` and
    ``_normalize_iter_state`` against the JAX classes on toy stateful
    iterators (JAX's put on the CPU with ``jax.device_put``).
  * A failed build of the nvJPEG binding raises through the pipeline; it
    is never replaced by the CPU decoder.

The colour kernel and the decode on the card: tests/test_torch_jpeg_kernel.py.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.data import grain_pipeline as gp
from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import pipeline
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.data import grain_pipeline as jax_gp
from attentionalpoolingaction_tpu.data import pipeline as jax_pipeline
from attentionalpoolingaction_tpu.data import preprocessing_np as ppnp

torch.set_num_threads(2)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_torch")
GOLDEN = np.load(os.path.join(FIXTURES, "golden.npz"))
NAMES = [str(n) for n in GOLDEN["names"]]
# the crops of the JPEG fixtures, as tests/fixtures_torch/make_fixtures.py
# made them (224 px of resize_min 256, resize_max 512)
OUT, RMIN, RMAX, TRAIN_SEED = 224, 256, 512, 1000


def fixture(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def assert_within_one_level(got, want, frac=1e-3):
    """Within 1 level everywhere, and off by more than half a level on at
    most ``frac`` of the values (None: no such bound)."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 1.0, diff.max()
    if frac is not None:
        assert (diff > 0.5).mean() <= frac, (diff > 0.5).mean()


@pytest.mark.parametrize("name", NAMES)
def test_fixture_crops_match_the_jax_pipeline(name):
    """The goldens still are the JAX pipeline's output, and the port's CPU
    path gives the same geometry and transform exactly and the pixels
    within 1 level."""
    i = NAMES.index(name)
    data = fixture(name)
    h, w = jpeg.image_size(data)
    decoded = jpeg.decode([data], "cpu")[0]
    np.testing.assert_array_equal(decoded.numpy(), ppnp.decode_jpeg(data))
    for kind in ("eval", "train"):
        train_ = kind == "train"
        golden = np.cumsum(GOLDEN[f"{kind}_image_dx"][i], axis=1,
                           dtype=np.uint8)
        want, want_t = ppnp.preprocess_decoded_np(
            ppnp.decode_jpeg(data), out_size=OUT, is_training=train_,
            resize_min=RMIN, resize_max=RMAX, keep_uint8=True,
            rng=np.random.default_rng(TRAIN_SEED + i) if train_ else None)
        np.testing.assert_array_equal(want, golden)
        np.testing.assert_array_equal(want_t, GOLDEN[f"{kind}_transform"][i])
        g = pp.draw_geometry(
            h, w, out_size=OUT, is_training=train_, resize_min=RMIN,
            resize_max=RMAX,
            rng=np.random.default_rng(TRAIN_SEED + i) if train_ else None)
        np.testing.assert_array_equal(g.transform(), want_t)
        got = pp.apply_geometry(decoded, g, out_size=OUT, keep_uint8=True)
        assert got.dtype == torch.uint8 and got.shape == (OUT, OUT, 3)
        assert_within_one_level(got.numpy(), want)


@pytest.mark.parametrize("h, w, seed", [(720, 1280, 0), (640, 480, 1),
                                        (333, 517, 2), (50, 70, 3)])
def test_geometry_and_float_crops_equal_jax(h, w, seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (h, w, 3), np.uint8)
    for draw in range(4):
        want, want_t = ppnp.preprocess_decoded_np(
            image, out_size=48, is_training=True, resize_min=56,
            resize_max=112, rng=np.random.default_rng([seed, draw]))
        g = pp.draw_geometry(h, w, out_size=48, is_training=True,
                             resize_min=56, resize_max=112,
                             rng=np.random.default_rng([seed, draw]))
        np.testing.assert_array_equal(g.transform(), want_t)
        got = pp.apply_geometry(torch.from_numpy(image), g, out_size=48)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=0.05)
    with pytest.raises(ValueError, match="rng"):
        pp.draw_geometry(h, w, out_size=48, is_training=True, resize_min=56,
                         resize_max=112)


@pytest.mark.parametrize("name", ["mpii_b_1280x720.jpg",
                                  "portrait_480x640.jpg"])
def test_multicrop_geometry_equals_jax(name):
    data = fixture(name)
    want = ppnp.eval_multicrop_np(data, out_size=OUT, resize_min=RMIN,
                                  num_crops=3)
    h, w = jpeg.image_size(data)
    geoms = pp.multicrop_geometry(h, w, out_size=OUT, resize_min=RMIN,
                                  num_crops=3)
    got = pp.apply_multicrop(jpeg.decode([data], "cpu")[0], geoms,
                             out_size=OUT)
    assert got.shape == want.shape == (3, OUT, OUT, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=0.01)


@pytest.fixture(scope="module")
def mpii_records(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_mpii")
    spec = get_dataset("mpii")
    path = str(d / "val.tfrecord")
    records.write_synthetic_dataset(path, spec, 10, image_size=80, seed=2,
                                    class_signal=0.6)
    return path


@pytest.mark.parametrize("name", ["mpii", "hico"])
def test_eval_batches_equal_jax(tmp_path, mpii_records, name):
    spec = get_dataset(name)
    path = mpii_records
    if name == "hico":
        path = str(tmp_path / "hico.tfrecord")
        records.write_synthetic_dataset(path, spec, 7, image_size=72, seed=4)
    kw = dict(batch_size=4, image_size=64, resize_min=72)
    port = list(gp.make_eval_dataset(path, spec, device="cpu", **kw))
    jax = list(jax_gp.make_eval_dataset(path, spec, **kw))
    assert len(port) == len(jax) == len(gp.make_eval_dataset(
        path, spec, device="cpu", **kw))
    for p, j in zip(port, jax):
        assert p.keys() == j.keys()
        for k in j:
            if k == "image":
                assert p[k].dtype == torch.float32
                assert_within_one_level(p[k].numpy(), j[k])
            else:
                assert p[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    if name == "hico":
        assert np.any(port[0]["anno"] != 0)
    # the tf.data eval's uint8 images are the same crops, rounded; at 80
    # -> 72 px many resampled values are exact halves, which the two
    # resamplers' last bits send to either neighbour
    u8 = next(iter(gp.make_eval_dataset(path, spec, transfer_uint8=True,
                                        device="cpu", **kw)))
    assert u8["image"].dtype == torch.uint8
    mean = np.array([pp.R_MEAN, pp.G_MEAN, pp.B_MEAN], np.float32)
    assert_within_one_level(
        u8["image"].numpy(),
        np.clip(np.round(jax[0]["image"] + mean), 0, 255), frac=None)


def test_multicrop_eval_batches_equal_jax(mpii_records):
    spec = get_dataset("mpii")
    kw = dict(batch_size=4, image_size=48, resize_min=56, num_crops=3)
    port = list(gp.make_multicrop_eval_dataset(mpii_records, spec,
                                               device="cpu", **kw))
    jax = list(jax_gp.make_multicrop_eval_dataset(mpii_records, spec, **kw))
    assert len(port) == len(jax) == 3
    for p, j in zip(port, jax):
        assert p.keys() == j.keys()
        assert p["image"].shape == (4, 3, 48, 48, 3)
        assert_within_one_level(p["image"].numpy(), j["image"])
        for k in set(j) - {"image"}:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.fixture(scope="module")
def numbered_records(tmp_path_factory):
    """13 tiny records whose label is their index."""
    d = tmp_path_factory.mktemp("numbered")
    jpg = records._cv2_encode_jpeg(np.full((12, 12, 3), 99, np.uint8))
    path = str(d / "n.tfrecord")
    records.write_tfrecord(path, [
        records.make_example(jpg, height=12, width=12, label=i,
                             keypoints=np.zeros((16, 2), np.float32))
        for i in range(13)])
    return path


def stream(path, n_batches, state=None, **kw):
    args = dict(batch_size=3, image_size=8, resize_min=10, resize_max=14,
                seed=7, device="cpu")
    args.update(kw)
    it = gp.make_train_iterator(path, get_dataset("mpii"), **args)
    if state is not None:
        it.set_state(state)
    try:
        return [next(it) for _ in range(n_batches)], it.get_state()
    finally:
        it.close()


def labels(batches):
    return np.concatenate([b["label"] for b in batches]).tolist()


def test_train_stream_properties(numbered_records):
    batches, state = stream(numbered_records, 9)        # 27 = 2 epochs + 1
    seen = labels(batches)
    first, second = seen[:13], seen[13:26]
    assert sorted(first) == sorted(second) == list(range(13))
    assert first != second
    assert state == {"epoch": 2, "position": 1}
    again, _ = stream(numbered_records, 9, num_workers=3)
    assert labels(again) == seen
    for a, b in zip(batches, again):
        assert torch.equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["transform"], b["transform"])
    other, _ = stream(numbered_records, 9, seed=8)
    assert labels(other) != seen
    # transforms come from the keyed generator, so they vary
    assert len({tuple(t) for b in batches for t in b["transform"]}) > 3
    shards = [labels(stream(numbered_records, 2, shard_index=i,
                            shard_count=3)[0]) for i in range(3)]
    assert sorted(shards[0][:5]) == list(range(0, 13, 3))
    assert sorted(shards[1][:4]) == list(range(1, 13, 3))
    assert sorted(shards[2][:4]) == list(range(2, 13, 3))


@pytest.mark.parametrize("workers", [0, 2])
def test_mid_epoch_resume_is_bitwise(numbered_records, workers):
    whole, _ = stream(numbered_records, 7, num_workers=workers)
    head, state = stream(numbered_records, 2, num_workers=workers)
    assert state == {"epoch": 0, "position": 6}
    tail, _ = stream(numbered_records, 5, state=state, num_workers=workers)
    for a, b in zip(whole, head + tail):
        assert a.keys() == b.keys()
        assert torch.equal(a["image"], b["image"])
        for k in set(a) - {"image"}:
            np.testing.assert_array_equal(a[k], b[k])


class ToyStateful:
    """A stateful iterator of numbered numpy batches."""

    def __init__(self, n=9):
        self.n, self.pos = n, 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos >= self.n:
            raise StopIteration
        self.pos += 1
        return {"x": np.full((2, 3), self.pos - 1, np.float32),
                "label": np.array([self.pos - 1, 0], np.int32)}

    def get_state(self):
        return {"pos": self.pos}

    def set_state(self, state):
        self.pos = state["pos"]


def run_wrapper(make, steps, restore_at=None):
    """(values seen, states after each step) of a wrapper over a toy
    iterator; with ``restore_at`` a fresh wrapper restores the state taken
    there and carries on."""
    w = make(ToyStateful())
    seen, states = [], []
    for i in range(steps):
        if restore_at is not None and i == restore_at:
            saved = states[-1]
            w = make(ToyStateful())
            w.set_state(saved)
        b = next(w)
        seen.append(float(np.asarray(b["x"])[0, 0]))
        states.append(w.get_state())
    return seen, states


@pytest.mark.parametrize("echo", [1, 2, 3])
@pytest.mark.parametrize("restore_at", [None, 3, 4])
def test_wrappers_equal_jax(echo, restore_at):
    def port(it):
        return pipeline.EchoIterator(
            pipeline.StatefulPrefetchIterator(it, device="cpu"), echo)

    def jax_(it):
        return jax_pipeline.EchoIterator(
            jax_pipeline.StatefulPrefetchIterator(it), echo)

    got = run_wrapper(port, 8, restore_at)
    want = run_wrapper(jax_, 8, restore_at)
    assert got == want
    assert got[0] == run_wrapper(port, 8)[0]    # a restore changes nothing


def test_prefetch_and_plain_state_equal_jax():
    got = run_wrapper(lambda it: pipeline.StatefulPrefetchIterator(
        it, size=3, device="cpu"), 9)
    want = run_wrapper(lambda it: jax_pipeline.StatefulPrefetchIterator(
        it, size=3), 9)
    assert got == want
    out = list(pipeline.prefetch_to_device(iter(ToyStateful(5)),
                                           device="cpu"))
    ref = list(jax_pipeline.prefetch_to_device(iter(ToyStateful(5))))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        assert isinstance(o["x"], torch.Tensor) and isinstance(
            r["x"], jax.Array)
        np.testing.assert_array_equal(o["x"].numpy(), np.asarray(r["x"]))
        assert o["label"].dtype == torch.int32
    # a tensor already on the device passes through untouched
    t = torch.ones(2)
    assert train.batch_to_device({"t": t}, "cpu")["t"] is t


@pytest.mark.parametrize("state, echo", [
    ({"pos": 3}, 1), ({"pos": 3}, 2),
    ({"inner_before": {"pos": 3}, "phase": 0}, 2),
    ({"inner_before": {"pos": 3}, "phase": 1}, 2),
    ({"inner_before": {"pos": 3}, "phase": 1}, 1),
    ({"inner_before": {"pos": 3}, "phase": 0}, 1)])
def test_normalize_iter_state_equals_jax(state, echo):
    assert train._normalize_iter_state(state, echo) == \
        jax_train._normalize_iter_state(state, echo)


def test_a_failed_decoder_build_is_not_swallowed(mpii_records, monkeypatch):
    """On a CUDA device the pipeline decodes with nvJPEG or raises: a build
    failure comes through, and OpenCV is never tried in its place."""
    def fail_build():
        raise RuntimeError("nvcc failed on csrc/jpeg_decode.cu: test")

    monkeypatch.setattr(jpeg.LIBRARY, "build", fail_build)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(sys.modules, "cv2", None)   # importing it fails
    data = fixture(NAMES[0])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        jpeg.decode([data], "cuda")
    ds = gp.make_eval_dataset(mpii_records, get_dataset("mpii"),
                              batch_size=4, image_size=64, resize_min=72,
                              device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        next(iter(ds))
    assert not jpeg.LIBRARY.loaded() and jpeg.decode_count == 0
