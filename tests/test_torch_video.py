"""The port's video path (HMDB51, BASELINE config #4) against the JAX
package's, on the CPU, over the same records written by the port:

  * ``build_video_index`` equals JAX's; the ``<file>.vidx.json`` sidecar
    written by either package is read by the other without a rescan, and
    a stale key (the file rewritten) rebuilds it.
  * ``_segment_picks`` equals JAX's draw for draw (n 1-40, clip_frames 1,
    2 and 8, seeded generators, several eval fractions).
  * The clip geometry and transform equal ``preprocess_clip_np``'s for
    the same draws (train, eval, the diagonal eval crops, a ragged
    frame), the pixels within 1 level (OpenCV decode on both sides; the
    two bilinear resamplers differ by thousandths of a level).
  * ``make_video_clip_eval_dataset``: rows, picks (``frame``), masks,
    labels, video ids and transforms equal JAX's batch for batch.
  * The video train stream draws one fresh frame (or clip) of every video
    each epoch, and resumes bit for bit mid-epoch, through the prefetch
    and mid-echo.  Its order differs from JAX's Grain shuffle by design.
  * One ``hmdb51_clip8``-shaped train step (T=2, batch 2, float32) port
    vs JAX within ``tests/test_torch_train_step.py``'s first-step
    tolerances, and clip eval from the records (2 clips x 3 crops) within
    1e-3 of the logits (the resamplers' difference) and with equal
    metrics.
  * JAX's clip config errors are the port's ``ValueError``s too.
"""

import json
import os
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.data import grain_pipeline as gp
from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import native_io
from attentionalpoolingaction_torch.data import pipeline
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import evaluate as jax_eval
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.data import grain_pipeline as jax_gp
from attentionalpoolingaction_tpu.data import native_io as jax_native_io
from attentionalpoolingaction_tpu.data import preprocessing_np as ppnp

torch.set_num_threads(2)
SPEC = get_dataset("hmdb51")
# frames a video, by video id, split over two files; video 4 has a ragged
# frame of another size
LENGTHS = {0: 5, 1: 1, 2: 9, 3: 3, 4: 6, 5: 2, 6: 11}


def frame_jpeg(vid, frame):
    rng = np.random.default_rng(1000 * vid + frame)
    h, w = (44, 60) if not (vid == 4 and frame == 2) else (40, 50)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img[:, :, 0] = (40 * vid + 20 * frame) % 256     # a visible signature
    return cv2.imencode(".jpg", img)[1].tobytes(), h, w


@pytest.fixture(scope="module")
def video_records(tmp_path_factory):
    """Two files of per-frame HMDB51 records (a video's frames in order in
    one file, the videos interleaved); a glob of both."""
    d = tmp_path_factory.mktemp("hmdb")
    files = [[], []]
    for f in range(max(LENGTHS.values())):
        for v, n in LENGTHS.items():
            if f < n:
                data, h, w = frame_jpeg(v, f)
                files[v % 2].append(records.make_example(
                    data, height=h, width=w, label=(7 * v) % 51,
                    video_id=v, frame=f))
    for i, examples in enumerate(files):
        records.write_tfrecord(str(d / f"part{i}.tfrecord"), examples)
    return str(d / "part*.tfrecord")


def sidecars(pattern):
    return [p + ".vidx.json" for p in native_io._paths(pattern)]


def test_build_video_index_equals_jax_and_shares_its_sidecar(
        video_records, monkeypatch):
    for p in sidecars(video_records):
        if os.path.exists(p):
            os.remove(p)
    port = gp.build_video_index(native_io.make_source(video_records), SPEC)
    assert all(os.path.exists(p) for p in sidecars(video_records))
    # JAX reads the port's sidecars without a scan
    monkeypatch.setattr(jax_gp, "_record_video_ids", None)
    want = jax_gp.build_video_index(
        jax_native_io.make_source(video_records), SPEC)
    monkeypatch.undo()
    assert port == want
    assert {v: len(ix) for v, ix in port.items()} == LENGTHS
    # and the port reads JAX's
    for p in sidecars(video_records):
        os.remove(p)
    jax_gp.build_video_index(jax_native_io.make_source(video_records), SPEC)
    monkeypatch.setattr(gp, "_record_video_ids", None)
    assert gp.build_video_index(native_io.make_source(video_records),
                                SPEC) == want
    monkeypatch.undo()
    # a stale key (the file rewritten since) rebuilds the sidecar
    first = native_io._paths(video_records)[0]
    sidecar = json.loads(open(first + ".vidx.json").read())
    stale = dict(sidecar, key=[sidecar["key"][0], sidecar["key"][1] - 1],
                 video_ids=[99] * len(sidecar["video_ids"]))
    with open(first + ".vidx.json", "w") as f:
        json.dump(stale, f)
    assert gp.build_video_index(native_io.make_source(video_records),
                                SPEC) == want
    assert json.loads(open(first + ".vidx.json").read()) == sidecar


def test_segment_picks_equal_jax():
    for n in range(1, 41):
        for t in (1, 2, 8):
            for seed in range(3):
                assert gp._segment_picks(
                    n, t, np.random.default_rng(seed)) == \
                    jax_gp._segment_picks(n, t, np.random.default_rng(seed))
            for frac in (0.5, 0.25, 1 / 6, 0.9, 0.0):
                assert gp._segment_picks(n, t, frac=frac) == \
                    jax_gp._segment_picks(n, t, frac=frac), (n, t, frac)


def assert_within_one_level(got, want):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 1.0, diff.max()
    assert (diff > 0.5).mean() <= 1e-3, (diff > 0.5).mean()


@pytest.mark.parametrize("vid", [0, 4])
@pytest.mark.parametrize("kind", ["train", "eval", "crop0", "crop0.5",
                                  "crop1"])
def test_clip_geometry_and_pixels_equal_jax(vid, kind):
    datas = [frame_jpeg(vid, f)[0] for f in range(LENGTHS[vid])]
    train_mode = kind == "train"
    crop_frac = float(kind[4:]) if kind.startswith("crop") else None
    kw = dict(out_size=32, is_training=train_mode, resize_min=36,
              resize_max=52 if train_mode else None)
    for seed in range(3):
        for keep_uint8 in (False, True):
            rng = np.random.default_rng(seed) if train_mode else None
            want, transform = ppnp.preprocess_clip_np(
                datas, rng=rng, keep_uint8=keep_uint8, crop_frac=crop_frac,
                **kw)
            h, w = jpeg.image_size(datas[0])
            g = pp.draw_geometry(h, w, crop_frac=crop_frac, rng=(
                np.random.default_rng(seed) if train_mode else None), **kw)
            np.testing.assert_array_equal(g.transform(), transform)
            got = pp.apply_clip(jpeg.decode(datas, "cpu"), g, out_size=32,
                                keep_uint8=keep_uint8)
            assert got.shape == want.shape == (len(datas), 32, 32, 3)
            assert got.dtype == (torch.uint8 if keep_uint8
                                 else torch.float32)
            if keep_uint8:      # rounding sends exact halves either way
                diff = np.abs(got.numpy().astype(int) - want.astype(int))
                assert diff.max() <= 1
            else:
                assert_within_one_level(got.numpy(), want)


def test_clip_eval_batches_equal_jax(video_records):
    kw = dict(batch_size=4, image_size=32, resize_min=36, clip_frames=2,
              num_clips=2, num_crops=3)
    port = list(gp.make_video_clip_eval_dataset(video_records, SPEC,
                                                device="cpu", **kw))
    want = list(jax_gp.make_video_clip_eval_dataset(video_records, SPEC,
                                                    **kw))
    rows = len(LENGTHS) * 2 * 3
    assert len(port) == len(want) == -(-rows // 4)
    assert sum(float(b["mask"].sum()) for b in port) == rows
    for p, j in zip(port, want):
        assert p.keys() == j.keys()
        assert p["image"].shape == (4, 2, 32, 32, 3)
        assert_within_one_level(p["image"].numpy(), j["image"])
        for k in set(j) - {"image"}:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def video_stream(pattern, n_batches, state=None, echo=1, **kw):
    """Batches of the video train stream through the prefetch (and the
    echo), and the outermost wrapper's state after them."""
    args = dict(batch_size=3, image_size=24, resize_min=28, resize_max=40,
                seed=5, transfer_uint8=True, device="cpu")
    args.update(kw)
    inner = gp.make_train_iterator(pattern, SPEC, video_sampling=True,
                                   **args)
    it = pipeline.StatefulPrefetchIterator(inner, device="cpu")
    if echo > 1:
        it = pipeline.EchoIterator(it, echo)
    if state is not None:
        it.set_state(state)
    try:
        return [next(it) for _ in range(n_batches)], it.get_state()
    finally:
        inner.close()


@pytest.mark.parametrize("clip_frames", [1, 3])
def test_video_stream_draws_each_video_once_an_epoch(video_records,
                                                     clip_frames):
    index = gp.build_video_index(native_io.make_source(video_records), SPEC)
    batches, state = video_stream(video_records, 7, clip_frames=clip_frames)
    vids = np.concatenate([b["video_id"] for b in batches]).tolist()
    frames = np.concatenate([b["frame"].reshape(len(b["frame"]), -1)
                             for b in batches])
    v = len(LENGTHS)
    assert state == {"epoch": 3, "position": 0}          # 21 = 3 epochs
    epochs = [vids[i * v:(i + 1) * v] for i in range(3)]
    assert all(sorted(e) == sorted(LENGTHS) for e in epochs)
    assert epochs[0] != epochs[1]
    for vid, fr in zip(vids, frames):
        assert len(fr) == clip_frames
        assert set(fr.tolist()) <= set(range(LENGTHS[vid]))
        assert list(fr) == sorted(fr)       # a clip is in temporal order
    # the frames drawn for a long video change from epoch to epoch
    long = [tuple(fr) for vid, fr in zip(vids, frames) if vid == 6]
    assert len(set(long)) > 1
    for b in batches:
        want = (3, clip_frames, 24, 24, 3) if clip_frames > 1 else (
            3, 24, 24, 3)
        assert b["image"].shape == want and b["image"].dtype == torch.uint8
        np.testing.assert_array_equal(b["label"], (7 * b["video_id"]) % 51)
    assert sum(len(ix) for ix in index.values()) == sum(LENGTHS.values())


@pytest.mark.parametrize("clip_frames, echo", [(1, 1), (2, 1), (2, 2)])
def test_video_stream_resumes_bit_for_bit(video_records, clip_frames, echo):
    whole, _ = video_stream(video_records, 8, echo=echo,
                            clip_frames=clip_frames, num_workers=2)
    cut = 3                     # mid-epoch, and mid-echo with echo 2
    head, state = video_stream(video_records, cut, echo=echo,
                               clip_frames=clip_frames)
    if echo > 1:
        assert state["phase"] == 1
    tail, _ = video_stream(video_records, 8 - cut, state=state, echo=echo,
                           clip_frames=clip_frames)
    for a, b in zip(whole, head + tail):
        assert a.keys() == b.keys()
        assert torch.equal(a["image"], b["image"])
        for k in set(a) - {"image"}:
            np.testing.assert_array_equal(a[k], b[k])


CLIP = dict(backbone="resnet_v1_50", image_size=32, batch_size=2,
            clip_frames=2, bf16_backbone=False, lr_schedule="constant",
            resize_min=36, resize_max=44, eval_batch_size=4,
            eval_clips=2, eval_multicrop=3)


def test_clip_train_step_and_eval_match_jax(video_records):
    jcfg = jax_config.get_config("hmdb51_clip8", **CLIP,
                                 eval_pattern=video_records)
    cfg = config_lib.get_config("hmdb51_clip8", **CLIP,
                                eval_pattern=video_records)
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=51, rank=1, num_positions=2, seed=3)
    model, tx = jax_train.build_model(jcfg), jax_train.make_optimizer(jcfg)
    jstate = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), ema_params=None)
    jstep = jax_train.make_train_step(model, SPEC, jcfg, tx)
    state, _ = train.create_state(cfg, device="cpu",
                                  variables=(params, stats))
    batch = next(iter(video_stream(video_records, 1, batch_size=2,
                                   image_size=32, resize_min=36,
                                   resize_max=44, clip_frames=2)[0]))
    batch = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in batch.items()}
    assert batch["image"].shape == (2, 2, 32, 32, 3)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, tm = train.make_train_step(SPEC, cfg)(
        state, train.batch_to_device(batch, "cpu"))
    for k, w in jm.items():
        tol = 1e-2 if k == "grad_norm" else 1e-4
        assert abs(float(tm[k]) - float(w)) <= tol * abs(float(w)), k

    # clip eval of the stepped weights: 7 videos x 2 clips x 3 crops
    jparams = jax_train.jax.tree.map(np.asarray, jstate.params)
    jstats = jax_train.jax.tree.map(np.asarray, jstate.batch_stats)
    evaluator = jax_eval.Evaluator(jcfg)
    jbatches = list(jax_eval.make_eval_input(jcfg, SPEC))
    want = evaluator(types.SimpleNamespace(params=jparams,
                                           batch_stats=jstats),
                     eval_iter=iter(jbatches))
    want_logits = np.concatenate([
        np.asarray(evaluator.step_fn(jparams, jstats, b["image"]))
        for b in jbatches])
    eval_state = types.SimpleNamespace(params=jparams, batch_stats=jstats,
                                       ema_params=None)
    port = eval_lib.Evaluator(cfg, device="cpu")
    host = port.logits(eval_state)
    err = np.abs(host["logits"] - want_logits).max() / \
        np.abs(want_logits).max()
    assert err < 1e-3, err
    got = eval_lib.compute_metrics(cfg, host)
    assert got.keys() == want.keys()
    assert got["num_examples"] == want["num_examples"] == 42
    assert got["num_videos"] == want["num_videos"] == len(LENGTHS)
    for k in ("accuracy", "per_clip_accuracy"):
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("kw", [
    dict(dataset="mpii", clip_frames=2),
    dict(dataset="hmdb51", clip_frames=2, input_pipeline="tfdata"),
    dict(dataset="hmdb51", clip_frames=2, video_frame_sampling=False)])
def test_clip_config_errors_match_jax(kw):
    small = dict(backbone="resnet_v1_50", image_size=32, batch_size=2,
                 bf16_backbone=False, pooling="attention")
    with pytest.raises(ValueError, match="clip_frames=2 requires") as want:
        jax_train.train(jax_config.TrainConfig(**small, **kw),
                        train_iter=iter([]), num_steps=1)
    with pytest.raises(ValueError, match="clip_frames=2 requires") as got:
        train.train(config_lib.TrainConfig(**small, **kw),
                    train_iter=iter([]), num_steps=1, device="cpu")
    assert str(got.value) == str(want.value)


def test_clip_eval_config_errors_match_jax(video_records):
    for kw in (dict(eval_clips=2), dict(clip_frames=2,
                                        input_pipeline="tfdata")):
        jcfg = jax_config.TrainConfig(dataset="hmdb51",
                                      eval_pattern=video_records, **kw)
        cfg = config_lib.TrainConfig(dataset="hmdb51",
                                     eval_pattern=video_records, **kw)
        with pytest.raises(ValueError) as want:
            jax_eval.make_eval_input(jcfg, SPEC)
        with pytest.raises(ValueError) as got:
            eval_lib.make_eval_input(cfg, SPEC, device="cpu")
        assert str(got.value) == str(want.value)


def test_hmdb51_rgb_trains_from_records(video_records, tmp_path):
    """``train.train`` of an ``hmdb51_rgb``-shaped config (bfloat16,
    per-epoch frame sampling) from the records, across an epoch
    boundary: finite losses; ``evaluate`` gives per-video accuracy."""
    cfg = config_lib.get_config(
        "hmdb51_rgb", backbone="resnet_v1_50", image_size=32, batch_size=4,
        resize_min=36, resize_max=44, train_pattern=video_records,
        eval_pattern=video_records, eval_batch_size=8, log_every=1)
    assert cfg.bf16_backbone and cfg.video_frame_sampling
    state, history = train.train(cfg, num_steps=3, device="cpu")
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss/total"]) for h in history)
    results = eval_lib.evaluate(cfg, state, device="cpu")
    assert results["num_videos"] == len(LENGTHS)
    assert results["num_examples"] == sum(LENGTHS.values())
    assert {"accuracy", "per_frame_accuracy"} <= set(results)
