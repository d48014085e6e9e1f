"""A run of each cell with its timed path broken underneath, at a small
size on the CPU (the look for a card skipped): ``correct`` has to come
out false for every fault the cell can have.

* serving: the answer altered where it is produced (the probabilities of
  a dispatch shifted by one class), and half of a dispatch's images left
  out (the others answered with the first ones' answers);
* training: a step that leaves the state unchanged, half of the batch
  left out (the loss a mean over the other half), the answer altered
  where it is produced (the loss 2% high), the decoded image altered
  where it is produced (red and blue swapped), and a step inside the
  window that leaves the parameters not finite.
"""

import argparse
import json
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from bench_h100 import common
from bench_h100 import run as bench_run

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
# small_run's warm steps: the window opens after them
JUDGED_AND_WARM = 4
SHRINK = {"backbone": "resnet_v1_50", "image_size": 64, "resize_min": 72,
          "resize_max": 144}


def small_run(workload: str, seed: int = 2 ** 31 + 21) -> dict:
    with tempfile.TemporaryDirectory() as d:
        ctx = bench_run.make_context(argparse.Namespace(
            workload=workload, seed=seed, seconds=1.0, trace=0), tmpdir=d,
            device="cpu", shrink=SHRINK)
        tr = ctx.traffic
        if tr["driver"] == "serve_http":
            tr.update(rate_per_s=12, warm_seconds=0.5, pool_images=6,
                      connections=4)
            tr["check"]["sample"] = 8
            tr["server"]["buckets"] = [1, 8]
            # coalesce several requests a dispatch at this low rate, so
            # that a fault in a dispatch's rows has rows to act on
            tr["server"]["max_wait_ms"] = 150.0
        else:
            tr.update(records=16, pool_images=4, warm_steps=JUDGED_AND_WARM)
            ctx.shrink["batch_size"] = 4
        out = common.driver_module(tr["driver"]).run(ctx)
        return bench_run.result_line(ctx, out, common.load_benchmark(ROOT))


def serving_faults(monkeypatch, fault):
    from attentionalpoolingaction_torch import serving
    if fault == "answer_altered":
        probs = serving.BucketedPredictor._probs
        monkeypatch.setattr(serving.BucketedPredictor, "_probs",
                            lambda self, lg: np.roll(probs(self, lg), 1, -1))
    elif fault == "half_the_batch":
        predict = serving.BucketedPredictor.predict_arrays

        def half(self, images):
            k = max(len(images) // 2, 1)
            out = predict(self, images[:k])
            return np.concatenate([out, out[:len(images) - k]])
        monkeypatch.setattr(serving.BucketedPredictor, "predict_arrays",
                            half)


def training_faults(monkeypatch, fault):
    from attentionalpoolingaction_torch import train as train_lib
    if fault == "state_unchanged":
        def still(state, cfg, schedule):
            state.step += 1
            return train_lib._global_norm(state, [p.grad for p in
                                                  state.model.parameters()])
        monkeypatch.setattr(train_lib, "apply_gradients", still)
    elif fault == "half_the_batch":
        make = train_lib.make_loss_fn

        def halved(spec, cfg, group=None):
            fn = make(spec, cfg, group)

            def loss_fn(model, batch, train):
                k = max(batch["image"].shape[0] // 2, 1)
                return fn(model, {n: v[:k] for n, v in batch.items()}, train)
            return loss_fn
        monkeypatch.setattr(train_lib, "make_loss_fn", halved)
    elif fault == "image_altered":
        to_device = train_lib.batch_to_device

        def swapped(batch, device):
            out = to_device(batch, device)
            return dict(out, image=out["image"].flip(-1).contiguous())
        monkeypatch.setattr(train_lib, "batch_to_device", swapped)
    elif fault == "window_nonfinite":
        apply = train_lib.apply_gradients

        def blown(state, cfg, schedule):
            norm = apply(state, cfg, schedule)
            if state.step > JUDGED_AND_WARM:    # a step of the window
                with torch.no_grad():
                    for p in state.model.parameters():
                        p.fill_(float("nan"))
            return norm
        monkeypatch.setattr(train_lib, "apply_gradients", blown)
    elif fault == "answer_altered":
        loss = train_lib.classification_loss
        monkeypatch.setattr(train_lib, "classification_loss",
                            lambda *a, **k: loss(*a, **k) * 1.02)


@pytest.mark.parametrize("fault", ["answer_altered", "half_the_batch"])
def test_serving_fault_is_not_correct(monkeypatch, fault):
    serving_faults(monkeypatch, fault)
    line = small_run("mpii224_http_poisson")
    assert line["correct"] is False, json.dumps(line["checks"])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "image_altered",
                                   "window_nonfinite"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    training_faults(monkeypatch, fault)
    line = small_run("mpii224_train_records")
    assert line["correct"] is False, json.dumps(line["checks"])


@pytest.mark.parametrize("workload", ["mpii224_http_poisson",
                                      "mpii224_train_records"])
def test_sound_small_run_is_correct(workload):
    line = small_run(workload)
    assert line["correct"] is True, json.dumps(line["checks"])
    assert line["failed"] == 0 and line["attempted"] > 0
