"""The port's serving layer: its Predictor vs the JAX package's on the same
Flax weights, and the DynamicBatcher's admission and shutdown.

Predictor parity: resnet_v1_50 at 64 px, MPII, buckets (1, 4); 6 uint8
images, so one chunk fills bucket 4 and the other is padded from 2 to 4.
Tolerance 1e-4 on the probabilities (float32 on both sides).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu import serving as jax_serving
from attentionalpoolingaction_tpu.config import TrainConfig as JaxConfig
from attentionalpoolingaction_tpu.models.action_model import ActionModel
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.config import TrainConfig

torch.set_num_threads(2)

CFG = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
           rank=1, image_size=64, batch_size=4, bf16_backbone=False,
           resize_min=72)


@pytest.fixture(scope="module")
def flax_variables():
    model = ActionModel(num_classes=393, backbone="resnet_v1_50",
                        pooling="attention", rank=1)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                           train=False)
    variables = jax.tree.map(np.asarray, variables)
    # uint8 images give init logits ~1e4 and a one-hot softmax; shrinking
    # both head branches 100x brings them to O(1), so that the
    # probabilities compared below are not all 0 or 1
    head = variables["params"]["head"]
    head["attn_w"] = head["attn_w"] * np.float32(0.01)
    head["sal_w"] = head["sal_w"] * np.float32(0.01)
    return variables


@pytest.fixture(scope="module")
def predictor(flax_variables):
    return serving.Predictor(TrainConfig(**CFG), flax_variables["params"],
                             flax_variables["batch_stats"], buckets=(1, 4),
                             device="cpu")


def test_predict_arrays_matches_jax(flax_variables, predictor):
    ref = jax_serving.Predictor(JaxConfig(**CFG), flax_variables["params"],
                                flax_variables["batch_stats"],
                                buckets=(1, 4))
    imgs = np.random.default_rng(0).integers(0, 256, (6, 64, 64, 3),
                                             dtype=np.uint8)
    want = ref.predict_arrays(imgs)
    got = predictor.predict_arrays(imgs)
    assert got.shape == want.shape == (6, 393)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.allclose(got.sum(-1), 1.0, atol=1e-5)
    snap = predictor.stats.snapshot()
    assert snap["serving_device_dispatches_total"] == 2
    assert snap["serving_padded_items_total"] == 2


def test_bucketing_and_topk(predictor):
    assert predictor._bucket(1) == 1
    assert predictor._bucket(3) == 4
    assert predictor._bucket(9) == 4         # chunked at the largest bucket
    imgs = np.random.default_rng(1).integers(0, 256, (3, 64, 64, 3),
                                             dtype=np.uint8)
    res = predictor.predict_preprocessed(list(imgs), topk=3)
    assert len(res) == 3
    for r in res:
        probs = [e["prob"] for e in r["topk"]]
        assert len(probs) == 3 and probs == sorted(probs, reverse=True)


def test_reload_swaps_weights(flax_variables, predictor):
    imgs = np.random.default_rng(2).integers(0, 256, (1, 64, 64, 3),
                                             dtype=np.uint8)
    before = predictor.predict_arrays(imgs)
    params = dict(flax_variables["params"])
    # a per-class shift: a shift shared by all classes leaves the softmax
    bump = np.random.default_rng(4).normal(
        size=params["head"]["attn_b"].shape).astype(np.float32)
    params["head"] = dict(params["head"],
                          attn_b=params["head"]["attn_b"] + bump)
    old = predictor._weights
    predictor.reload(params, flax_variables["batch_stats"], step=5)
    try:
        assert predictor._weights is not old
        assert predictor.step == 5
        assert not np.allclose(predictor.predict_arrays(imgs), before)
    finally:
        predictor.reload(flax_variables["params"],
                         flax_variables["batch_stats"])


def test_predictor_needs_a_card_unless_told_cpu(flax_variables, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.Predictor(TrainConfig(**CFG), flax_variables["params"],
                          flax_variables["batch_stats"])


def _blocking_batcher(**kw):
    release = threading.Event()

    def predict(items):
        release.wait(timeout=10)
        return list(items)

    return serving.DynamicBatcher(predict, max_batch=1, max_wait_ms=1.0,
                                  **kw), release


def test_batcher_coalesces_through_predictor(predictor):
    b = serving.DynamicBatcher(predictor.predict_preprocessed, max_batch=4,
                               max_wait_ms=50.0)
    try:
        imgs = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3),
                                                 dtype=np.uint8)
        futs = [b.submit(img) for img in imgs]
        res = [f.result(timeout=30) for f in futs]
    finally:
        b.stop()
    assert all(len(r["topk"]) == 5 for r in res)
    assert b.stats.snapshot()["serving_coalesced_items_total"] == 4


def test_batcher_overloaded_and_retry_after():
    b, release = _blocking_batcher(max_queue=2)
    try:
        first = b.submit(0)
        time.sleep(0.2)              # the worker holds item 0 in predict
        b.submit(1)
        b.submit(2)
        with pytest.raises(serving.Overloaded, match="queue full"):
            b.submit(3)
        assert b.stats.snapshot()["serving_rejected_total"] == 1
        assert b.retry_after_seconds() >= 1
    finally:
        release.set()
        b.stop()
    assert first.result(timeout=5) == 0


def test_batcher_submit_many_is_atomic():
    b, release = _blocking_batcher(max_queue=3)
    try:
        b.submit(0)
        time.sleep(0.2)
        b.submit(1)
        with pytest.raises(serving.Overloaded, match="cannot admit 3"):
            b.submit_many([2, 3, 4])
        assert b._q.qsize() == 1         # none of the three went in
        futs = b.submit_many([5, 6])     # exactly fills the queue
        assert len(futs) == 2
    finally:
        release.set()
        b.stop()


def test_batcher_stop_fails_queued_futures():
    b, release = _blocking_batcher()
    first = b.submit(0)
    time.sleep(0.2)
    queued = b.submit(1)
    # stop() is under way (flag set, joining the busy worker) before the
    # worker is released, so it never takes the queued item
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    while not b._stop.is_set():
        time.sleep(0.01)
    release.set()
    stopper.join(timeout=10)
    assert not stopper.is_alive()
    assert first.result(timeout=5) == 0
    with pytest.raises(RuntimeError, match="shut down"):
        queued.result(timeout=5)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(2).result(timeout=5)
