"""The port's ``evaluate`` against the JAX package's ``evaluate(cfg, state,
eval_iter=...)`` on the same batches and the same weights, carried across
by the weight bridge: MPII (mAP, accuracy), HICO multi-label with ``anno``
(``mAP_ko``), HMDB per-video accuracy (of frames, and of 2-frame clips),
and 3-crop multicrop, each with a last batch padded by rows of ``mask``
0.  Also: evaluating the live training model leaves it as it was
(parameters, BN statistics, train mode), ``eval_ema``, the
``Evaluator``'s reload, and the pipelined loop's bits against a loop
that fetches each batch before the next.

resnet_v1_50 at 32 px, eval batch 4.  Tolerances: logits 1e-4 relative
(float32 through ResNet-50 in another order of summation, as
``tests/test_torch_resnet.py``); the metrics to 1e-6, since at these
seeds no two scores of a class are within the logits' difference of each
other, so every ranking is the same.  One JAX compile a dataset: the
JAX ``Evaluator``'s step gives its logits and its metrics."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_tpu import evaluate as jax_eval
from attentionalpoolingaction_tpu.config import TrainConfig as JaxConfig

torch.set_num_threads(2)
SIZE = 32
NUM_CLASSES = {"mpii": 393, "hico": 600, "hmdb51": 51}


def make_cfg(dataset, **kw):
    return dict(dataset=dataset, backbone="resnet_v1_50", pooling="attention",
                rank=1, image_size=SIZE, eval_batch_size=4,
                bf16_backbone=False, **kw)


def make_batches(dataset, n, seed, crops=0, frames=0):
    """Numpy eval batches of 4: the last one padded with mask-0 rows;
    (B, frames, S, S, 3) clips with ``frames``."""
    rng = np.random.default_rng(seed)
    c = NUM_CLASSES[dataset]
    lead = (n, crops or frames) if crops or frames else (n,)
    shape = lead + (SIZE, SIZE, 3)
    images = rng.integers(0, 256, shape, np.uint8)
    if dataset == "hico":
        anno = rng.choice([-1, 0, 1], size=(n, c), p=[0.6, 0.3, 0.1])
        anno[:, :8] = rng.choice([-1, 1], size=(n, 8))  # known, both signs
        labels = (anno > 0).astype(np.float32)
    else:
        labels = rng.integers(0, c, n).astype(np.int32)
    vids = rng.integers(0, 4, n).astype(np.int32)
    if dataset == "hmdb51":
        labels = (vids * 7 % c).astype(np.int32)   # one label a video
    out = []
    for lo in range(0, n, 4):
        sl = slice(lo, lo + 4)
        b = {"image": images[sl], "label": labels[sl],
             "mask": np.ones(len(images[sl]), np.float32)}
        if dataset == "hico":
            b["anno"] = anno[sl].astype(np.int32)
        if dataset == "hmdb51":
            b["video_id"] = vids[sl]
        pad = 4 - len(b["image"])
        if pad:
            b = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                v.dtype)])
                 for k, v in b.items()}
        out.append(b)
    return out


def variables_for(dataset, seed=0):
    return convert.random_flax_variables(
        "resnet_v1_50", num_classes=NUM_CLASSES[dataset], rank=1,
        num_positions=1, seed=seed)


CASES = {
    "mpii": ("mpii", {}, 0),
    "hico": ("hico", {}, 0),
    "hmdb51": ("hmdb51", {}, 0),
    "mpii-multicrop3": ("mpii", {"eval_multicrop": 3}, 3),
    # clip rows (2 clips of 2 frames a video), averaged per video
    "hmdb51-clip2": ("hmdb51", {"clip_frames": 2, "eval_clips": 2}, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_evaluate_matches_jax(case):
    dataset, extra, crops = CASES[case]
    kw = make_cfg(dataset, **extra)
    params, stats = variables_for(dataset)
    batches = make_batches(dataset, 10, seed=len(case), crops=crops,
                           frames=extra.get("clip_frames", 0))

    jax_evaluator = jax_eval.Evaluator(JaxConfig(**kw))
    want = jax_evaluator(types.SimpleNamespace(params=params,
                                               batch_stats=stats),
                         eval_iter=iter(batches), return_per_class=True)
    want_logits = np.concatenate([
        np.asarray(jax_evaluator.step_fn(params, stats, b["image"]))
        for b in batches])

    cfg = config_lib.TrainConfig(**kw)
    state = ckpt_lib.EvalState(step=0, params=params, batch_stats=stats)
    got = eval_lib.evaluate(cfg, state, eval_iter=iter(batches),
                            return_per_class=True, device="cpu")
    host = eval_lib.Evaluator(cfg, device="cpu").logits(state, iter(batches))
    err = np.abs(host["logits"] - want_logits).max() / \
        np.abs(want_logits).max()
    assert err < 1e-4, err

    assert got.keys() == want.keys()
    assert got["num_examples"] == want["num_examples"] == 10
    for k, w in want.items():
        if isinstance(w, list):
            np.testing.assert_allclose(
                np.array(got[k], np.float64), np.array(w, np.float64),
                rtol=0, atol=1e-6, err_msg=k)
        else:
            assert got[k] == pytest.approx(w, abs=1e-6), k
    if dataset == "hico":
        assert "mAP_ko" in got and got["mAP_ko"] != got["mAP"]
    if dataset == "hmdb51":
        per_row = ("per_clip_accuracy" if "clip_frames" in extra
                   else "per_frame_accuracy")
        assert got["num_videos"] == 4 and per_row in got


def small_state(**kw):
    cfg = config_lib.TrainConfig(**make_cfg("mpii", learning_rate=0.05,
                                            lr_schedule="constant", **kw))
    state, spec = train.create_state(cfg, device="cpu")
    step = train.make_train_step(spec, cfg)
    rng = np.random.default_rng(5)
    for _ in range(2):
        step(state, train.batch_to_device(
            {"image": rng.integers(0, 256, (2, SIZE, SIZE, 3), np.uint8),
             "label": rng.integers(0, 393, 2).astype(np.int32)}, "cpu"))
    return cfg, state


def test_live_model_is_left_as_it_was():
    """An eval hook evaluates the model it is training: afterwards the
    parameters, the BN running statistics (bitwise) and train mode are as
    before, and eval_ema did not write the EMA into the parameters."""
    cfg, state = small_state(ema_decay=0.5)
    state.model.train()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batches = make_batches("mpii", 6, seed=1)
    raw = eval_lib.evaluate(cfg, state, eval_iter=iter(batches))
    ema = eval_lib.evaluate(dataclasses.replace(cfg, eval_ema=True), state,
                            eval_iter=iter(batches))
    assert state.model.training
    after = state.model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert raw["mAP"] != ema["mAP"]
    # the EMA evaluated is the state's EMA: the same as arrays of it
    arrays = ckpt_lib.EvalState(
        step=2, params=convert.state_dict_to_flax(state.ema_params)[0],
        batch_stats=convert.state_dict_to_flax(state.model.state_dict())[1])
    assert eval_lib.evaluate(cfg, arrays, eval_iter=iter(batches),
                             device="cpu") == ema
    with pytest.raises(ValueError, match="no ema_params"):
        eval_lib.evaluate(dataclasses.replace(cfg, eval_ema=True),
                          dataclasses.replace(arrays, ema_params=None),
                          eval_iter=iter(batches), device="cpu")


def test_evaluator_reloads_and_pipelining_keeps_bits():
    cfg, state = small_state()
    batches = make_batches("mpii", 9, seed=2)
    evaluator = eval_lib.Evaluator(cfg, device="cpu")
    model = evaluator.model
    first = evaluator(state, eval_iter=iter(batches))
    with torch.no_grad():
        state.model.head.attn_w.neg_()      # reverses every ranking
    second = evaluator(state, eval_iter=iter(batches))
    assert evaluator.model is model and first != second
    assert second == eval_lib.evaluate(cfg, state, eval_iter=iter(batches))
    piped = eval_lib.eval_logits(evaluator.step_fn, iter(batches),
                                 device="cpu")
    # each batch fetched before the next is dispatched
    serial = {"logits": np.concatenate([
        evaluator.step_fn(torch.as_tensor(b["image"])).numpy()
        for b in batches])}
    for k in ("label", "mask"):
        serial[k] = np.concatenate([b[k] for b in batches])
    assert piped.keys() == serial.keys()
    for k in piped:
        np.testing.assert_array_equal(piped[k], serial[k])
    assert piped["logits"].shape == (12, 393)
    assert eval_lib.eval_logits(evaluator.step_fn, iter(batches),
                                device="cpu", max_batches=2)[
        "logits"].shape == (8, 393)


def test_unported_eval_paths_raise():
    cfg = config_lib.TrainConfig(**make_cfg("mpii"))
    # int8 evaluation is ported (tests/test_torch_inference.py); the step
    # of mesh_from_config's mesh is the process's own step (one card a
    # process: the split is what shards, tests/test_torch_parallel.py)
    int8 = eval_lib.Evaluator(dataclasses.replace(cfg, eval_int8=True),
                              device="cpu")
    assert int8.model is None and int8.int8_step is not None
    params, stats = variables_for("mpii")
    images = np.random.default_rng(0).integers(
        0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    steps = [eval_lib.make_int8_eval_step(cfg, mesh=mesh, device="cpu")
             for mesh in (eval_lib.mesh_from_config(cfg), None)]
    torch.testing.assert_close(
        *[s(params, stats, torch.from_numpy(images)) for s in steps],
        rtol=0, atol=0)
    evaluator = eval_lib.Evaluator(cfg, device="cpu")
    # without an eval_iter the split is read from cfg.eval_pattern
    with pytest.raises(ValueError, match="eval_pattern"):
        evaluator(ckpt_lib.EvalState(step=0, params=params,
                                     batch_stats=stats))
    assert eval_lib.mesh_from_config(cfg) is None
