"""Serving from the port's checkpoints: ``load_predictor`` at the latest
step, a given step and ``step="best"`` (the keep-best slot), with
``use_ema``; ``CheckpointFollower.poll_once`` swapping in a newer step
once, and a failed poll keeping the served weights.

The expected probabilities are those of a ``Predictor`` built from the
same weights as arrays (the same float32 forward on the CPU: equal).
resnet_v1_50 at 64 px, buckets (1, 4)."""

import dataclasses
import logging
import tempfile
import time

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def run():
    """A workdir with steps 1 and 2 in the rolling window (EMA on) and
    step 1 in the keep-best slot."""
    with tempfile.TemporaryDirectory() as workdir:
        cfg = config_lib.TrainConfig(
            dataset="mpii", backbone="resnet_v1_50", pooling="attention",
            image_size=64, batch_size=2, bf16_backbone=False,
            learning_rate=0.05, lr_schedule="constant", ema_decay=0.5,
            workdir=workdir)
        state, spec = train.create_state(cfg, device="cpu")
        step = train.make_train_step(spec, cfg)
        mgr = ckpt_lib.make_manager(workdir + "/checkpoints")
        keeper = ckpt_lib.BestKeeper(workdir)
        rng = np.random.default_rng(0)
        saved = {}
        for metric in (0.7, 0.4):
            step(state, train.batch_to_device(
                {"image": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
                 "label": rng.integers(0, 393, 2).astype(np.int32)}, "cpu"))
            ckpt_lib.save(mgr, state)
            keeper.update(state.step, {"mAP": metric}, state)
            saved[state.step] = ckpt_lib.restore_for_eval(mgr, state.step)
        yield {"cfg": cfg, "state": state, "mgr": mgr, "saved": saved,
               "images": rng.integers(0, 256, (3, 64, 64, 3), np.uint8)}


def reference_probs(run, step, use_ema=False):
    r = run["saved"][step]
    pred = serving.Predictor(run["cfg"], r.ema_params if use_ema
                             else r.params, r.batch_stats, buckets=(1, 4),
                             device="cpu")
    return pred.predict_arrays(run["images"])


@pytest.mark.parametrize("step, want_step", [
    (None, 2), (1, 1), ("2", 2), ("best", 1)])
@pytest.mark.parametrize("use_ema", [False, True])
def test_load_predictor(run, step, want_step, use_ema):
    pred = serving.load_predictor(run["cfg"], step=step, use_ema=use_ema,
                                  buckets=(1, 4), device="cpu")
    assert pred.step == want_step
    assert pred.stats.gauges()["serving_checkpoint_step"] == want_step
    np.testing.assert_array_equal(pred.predict_arrays(run["images"]),
                                  reference_probs(run, want_step, use_ema))


def test_load_predictor_errors(run, tmp_path):
    cfg = run["cfg"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        serving.load_predictor(dataclasses.replace(cfg, workdir=str(tmp_path)),
                               device="cpu")
    # int8 serving is ported (tests/test_torch_serving_bytes.py); a
    # missing calibration file raises.  data_parallel on a host of one
    # device is single-device dispatch (JAX's rule), float and int8 alike;
    # over two devices one replica each, the buckets rounded up to even
    with pytest.raises(FileNotFoundError):
        serving.load_predictor(cfg, device="cpu", int8=True,
                               calibration_files=("no-such.jpg",))
    for kw in (dict(data_parallel=True),
               dict(int8=True, data_parallel=True)):
        pred = serving.load_predictor(cfg, device="cpu", buckets=(1, 4),
                                      **kw)
        assert pred.replicas == () and pred.buckets == (1, 4)
        two = serving.load_predictor(cfg, device="cpu", buckets=(1, 4),
                                     devices=["cpu", "cpu"], **kw)
        assert len(two.replicas) == 2 and two.buckets == (2, 4)
        np.testing.assert_allclose(two.predict_arrays(run["images"]),
                                   pred.predict_arrays(run["images"]),
                                   rtol=1e-5, atol=1e-7)
    no_ema = ckpt_lib.EvalState(step=0, params={}, batch_stats={})
    with pytest.raises(ValueError, match="no ema_params"):
        serving.deploy_params(no_ema, use_ema=True)


def test_follower_swaps_once_and_survives_a_failed_poll(run, caplog):
    cfg, mgr = run["cfg"], run["mgr"]
    pred = serving.load_predictor(cfg, step=1, buckets=(1, 4), device="cpu")
    follower = serving.CheckpointFollower(pred, mgr)
    assert follower.poll_once()               # 2 is newer than 1
    assert pred.step == 2
    np.testing.assert_array_equal(pred.predict_arrays(run["images"]),
                                  reference_probs(run, 2))
    assert not follower.poll_once()           # nothing newer
    assert pred.stats.snapshot()["serving_reloads_total"] == 1

    # a step directory without its file: the poll raises, the thread
    # logs it and serves on with the weights it had
    (mgr.directory / "3").mkdir()
    try:
        with pytest.raises(ValueError, match="not a checkpoint"):
            follower.poll_once()
        weights = pred._weights
        thread = serving.CheckpointFollower(pred, mgr, poll_seconds=0.05)
        with caplog.at_level(logging.ERROR):
            thread.start()
            deadline = time.monotonic() + 10
            while "poll failed" not in caplog.text and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            thread.stop()
        assert not thread.is_alive()
        assert "poll failed" in caplog.text
        assert pred._weights is weights and pred.step == 2
        np.testing.assert_array_equal(pred.predict_arrays(run["images"]),
                                      reference_probs(run, 2))
    finally:
        (mgr.directory / "3").rmdir()


def test_follower_of_the_best_slot_with_ema(run):
    cfg = run["cfg"]
    best_mgr, _ = ckpt_lib.manager_for_step(cfg.workdir, "best")
    pred = serving.Predictor(cfg, *convert.random_flax_variables(
        "resnet_v1_50", num_classes=393, num_positions=4), buckets=(1, 4),
        device="cpu")
    follower = serving.CheckpointFollower(pred, best_mgr, use_ema=True)
    assert follower.poll_once() and pred.step == 1
    np.testing.assert_array_equal(pred.predict_arrays(run["images"]),
                                  reference_probs(run, 1, use_ema=True))
    assert not follower.poll_once()


def test_data_parallel_replicas_follow_a_new_step(run):
    """Two replicas on the CPU (eager dispatch: CUDA graphs are for
    replicas on cards) split a batch as one device computes it, and a
    follower's hot swap serves the new step on every replica."""
    cfg, mgr = run["cfg"], run["mgr"]
    two = serving.load_predictor(cfg, step=1, buckets=(1, 4), device="cpu",
                                 data_parallel=True, devices=["cpu", "cpu"])
    assert two._replica_graphs is None and len(two._weights) == 2
    np.testing.assert_allclose(two.predict_arrays(run["images"]),
                               reference_probs(run, 1), rtol=1e-5,
                               atol=1e-7)
    assert serving.CheckpointFollower(two, mgr).poll_once()
    assert two.step == 2 and len(two._weights) == 2
    np.testing.assert_allclose(two.predict_arrays(run["images"]),
                               reference_probs(run, 2), rtol=1e-5,
                               atol=1e-7)
