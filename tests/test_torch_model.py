"""The port's ActionModel vs the Flax one, with the Flax variables carried
across by convert.py: every pooling type, a 5-D clip, the attention maps,
and the committed golden logits of tests/test_golden_logits.py.

One Flax init serves every case: the golden model's (``key(7)``,
pose_attention, rank 2, 17 classes, resnet_v1_50); the attention model
drops its pose head and the avg model gets a numpy-seeded dense head.
Tolerance: 1e-4 of the largest magnitude (float32 backbone and head,
sums in other orders); the golden gate keeps its own 5e-4 drift bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attentionalpoolingaction_tpu.models import ActionModel as JaxActionModel
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch.models import get_model

torch.set_num_threads(2)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "attnpool_golden.npz")
NUM_CLASSES, RANK = 17, 2


def golden_input():
    x = jax.random.normal(jax.random.key(123), (2, 96, 96, 3),
                          jnp.float32) * 50.0
    return np.array(x)      # a writable copy for torch.from_numpy


@pytest.fixture(scope="module")
def golden_variables():
    model = JaxActionModel(num_classes=NUM_CLASSES, backbone="resnet_v1_50",
                           pooling="pose_attention", rank=RANK)
    variables = model.init(jax.random.key(7), jnp.asarray(golden_input()),
                           train=False)
    return jax.tree.map(np.asarray, variables)


def variables_for(pooling, golden):
    params = dict(golden["params"])
    if pooling != "pose_attention":
        params.pop("pose_head")
    if pooling == "avg":
        rng = np.random.default_rng(1)
        params["head"] = {"logits": {
            "kernel": rng.normal(0, 0.05, (2048, NUM_CLASSES)).astype(
                np.float32),
            "bias": rng.normal(0, 0.1, NUM_CLASSES).astype(np.float32)}}
    return params, golden["batch_stats"]


def run_both(pooling, golden, x, return_maps=False, image_size=96):
    params, stats = variables_for(pooling, golden)
    jmodel = JaxActionModel(num_classes=NUM_CLASSES, backbone="resnet_v1_50",
                            pooling=pooling, rank=RANK)
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), return_maps=return_maps)
    tmodel = get_model("resnet_v1_50", num_classes=NUM_CLASSES,
                       pooling=pooling, rank=RANK, image_size=image_size,
                       device="cpu")
    convert.load_flax_variables(tmodel, params, stats)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), return_maps=return_maps)
    assert set(got) == set(want)
    return got, want


def rel_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


@pytest.mark.parametrize("pooling", ["avg", "attention", "pose_attention"])
def test_action_model_matches_flax(golden_variables, pooling):
    x = golden_input()[:, :64, :64]
    got, want = run_both(pooling, golden_variables, x, image_size=64)
    for key in got:
        assert rel_err(got[key], want[key]) < 1e-4, key


def test_clip_and_maps_match_flax(golden_variables):
    """A 5-D (B, T, H, W, 3) clip folds T into the feature-map height;
    the per-frame attention maps come back (B, T, h, w, ...)."""
    clip = np.random.default_rng(2).normal(
        0, 50, (1, 2, 64, 64, 3)).astype(np.float32)
    got, want = run_both("attention", golden_variables, clip,
                         return_maps=True, image_size=64)
    assert got["attn_maps"].shape == (1, 2, 2, 2, NUM_CLASSES)
    assert got["saliency"].shape == (1, 2, 2, 2)
    for key in got:
        assert rel_err(got[key], want[key]) < 1e-4, key


def test_golden_logits(golden_variables):
    """The port, given the golden model's Flax variables, reproduces the
    committed golden outputs (tests/golden/attnpool_golden.npz)."""
    params, stats = variables_for("pose_attention", golden_variables)
    model = get_model("resnet_v1_50", num_classes=NUM_CLASSES,
                      pooling="pose_attention", rank=RANK, image_size=96,
                      device="cpu")
    convert.load_flax_variables(model, params, stats)
    with torch.no_grad():
        out = model(torch.from_numpy(golden_input()))
    got = {
        "logits": out["logits"].double().numpy(),
        "pose_mean": out["pose_heatmaps"].mean(dim=(1, 2)).double().numpy(),
        "feat_mean": out["features"].mean(dim=(1, 2, 3)).double().numpy(),
    }
    golden = np.load(GOLDEN_PATH)
    for key in ("logits", "pose_mean", "feat_mean"):
        scale = max(np.abs(golden[key]).max(), 1e-6)
        drift = np.abs(got[key] - golden[key]).max() / scale
        assert drift < 5e-4, f"{key} drifted by {drift:.2e}"


def test_bridge_rejects_missing_and_leftover_keys(golden_variables):
    params, stats = variables_for("attention", golden_variables)
    model = get_model("resnet_v1_50", num_classes=NUM_CLASSES,
                      pooling="attention", rank=RANK, device="cpu")
    extra = dict(params, extra={"kernel": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="extra"):
        convert.load_flax_variables(model, extra, stats)
    missing = dict(params, head={k: v for k, v in params["head"].items()
                                 if k != "sal_b"})
    with pytest.raises(RuntimeError, match="sal_b"):
        convert.load_flax_variables(model, missing, stats)


def test_random_flax_variables_fill_the_model():
    """The seeded stand-in for a checkpoint (what chip_smoke.py serves)
    fills every parameter of the model, strictly, and gives finite logits
    of a non-saturated softmax from uint8-range images."""
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=NUM_CLASSES, rank=RANK, num_positions=4)
    model = get_model("resnet_v1_50", num_classes=NUM_CLASSES,
                      pooling="attention", rank=RANK, image_size=64,
                      device="cpu")
    convert.load_flax_variables(model, params, stats)
    x = np.random.default_rng(3).uniform(-120, 130, (2, 64, 64, 3))
    with torch.no_grad():
        logits = model(torch.from_numpy(x.astype(np.float32)))["logits"]
    assert logits.shape == (2, NUM_CLASSES)
    assert torch.isfinite(logits).all()
    assert float(torch.softmax(logits, -1).max()) < 0.99


def test_get_model_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("resnet_v1_50", num_classes=3)
