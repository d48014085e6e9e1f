"""The port's train step vs the JAX package's ``make_train_step``, from the
same Flax variables (carried across by the weight bridge) on the same
numpy batches, on the CPU.

Two configurations, each over a few steps:

* the ``__graft_entry__.py`` config without its mesh: resnet_v1_50, 64 px,
  pose attention at rank 2, EMA 0.999, two microbatches a step (batch
  norm statistics chained through them), constant schedule, clip 10;
* the ``mpii_rank1_224`` preset's training defaults (batch 8, BN in train
  mode, staircase exponential schedule, SGD momentum, weight decay,
  clip 10) on resnet_v1_50 at 64 px.

Before each step the port's state (parameters, BN running statistics,
momentum buffers, EMA, step count) is set to the JAX state, so that each
step is compared from the same state: a randomly initialized ResNet with
batch norm in train mode is chaotic, and the two runs would otherwise
drift apart step by step.

Tolerances, and why.  Float32 rounding grows with depth through
train-mode batch norm (Flax also computes the variance as
E[x^2] - E[x]^2, which loses more), and moves ReLU inputs near zero
across the kink, so two correct float32 runs differ in their gradients
by a few percent in norm: ``python -m
attentionalpoolingaction_torch.precision`` measures the port's own
float32 step against its float64 one.  Hence: losses to 1e-3 relative (1e-4 on the first step); ``grad_norm`` to 1e-2; each BN
statistic's change to 1e-2 of its largest change (a running variance
moved toward the unbiased batch variance is off by 1/(n-1) of its
change, 3-14% in the last stage here, n = 8 to 32); the momentum
buffers (the clipped gradient plus the decay) to 0.2 relative in L2 per
leaf and 0.1 over all leaves; each parameter's and the EMA's change to
0.5 per leaf (some changes of BN scales near 1 are a few ulps) and 0.1
over all leaves.  ``test_torch_train_units.py`` holds the update itself
against optax, on the same gradients, to 1e-5.  A ``freeze_bn`` step
keeps the running statistics bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train

torch.set_num_threads(2)

GRAFT = dict(dataset="mpii", backbone="resnet_v1_50",
             pooling="pose_attention", rank=2, image_size=64, batch_size=4,
             bf16_backbone=False, learning_rate=1e-3, grad_clip_norm=10.0,
             lr_schedule="constant", ema_decay=0.999, grad_accum_steps=2)
MPII_DEFAULTS = dict(backbone="resnet_v1_50", image_size=64)


def make_batch(rng, cfg):
    b, size = cfg.batch_size, cfg.image_size
    batch = {
        "image": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
        "label": rng.integers(0, 393, b).astype(np.int32),
    }
    if cfg.pooling == "pose_attention":
        flip = (np.arange(b) % 2).astype(np.float32)
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(0, 8, b), rng.uniform(0, 8, b), flip],
            axis=1).astype(np.float32)
        batch["keypoints"] = rng.uniform(0, size, (b, 16, 2)).astype(
            np.float32)
        batch["visibility"] = (rng.uniform(size=(b, 16)) > 0.2).astype(
            np.float32)
    return batch


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def trace_of(opt_state):
    """The SGD momentum (optax ``trace``) inside the optimizer chain."""
    found = [s.trace for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(found) == 1
    return found[0]


def sync_from_jax(tstate, jstate):
    """Set the port's state to the JAX state, through the weight bridge."""
    convert.load_flax_variables(tstate.model, to_numpy(jstate.params),
                                to_numpy(jstate.batch_stats))
    named = dict(tstate.model.named_parameters())
    if int(jstate.step):
        trace = to_numpy(trace_of(jstate.opt_state))
        for n, t in convert.flax_to_state_dict(trace).items():
            tstate.optimizer.state[named[n]]["momentum_buffer"] = t
    if jstate.ema_params is not None:
        ema = convert.flax_to_state_dict(to_numpy(jstate.ema_params))
        for n, t in ema.items():
            tstate.ema_params[n].copy_(t)
    tstate.step = int(jstate.step)


def snapshot(tstate):
    """Parameters, BN statistics, momentum buffers and EMA, as copies."""
    opt = tstate.optimizer
    return {
        "params": {n: p.detach().clone()
                   for n, p in tstate.model.named_parameters()},
        "stats": {k: v.clone() for k, v in tstate.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))},
        "momentum": {n: opt.state[p]["momentum_buffer"].clone()
                     for n, p in tstate.model.named_parameters()},
        "ema": ({n: t.clone() for n, t in tstate.ema_params.items()}
                if tstate.ema_params is not None else None),
    }


def jax_snapshot(jstate):
    params = convert.flax_to_state_dict(to_numpy(jstate.params))
    return {
        "params": params,
        "stats": convert.flax_to_state_dict({}, to_numpy(jstate.batch_stats)),
        "momentum": (convert.flax_to_state_dict(
            to_numpy(trace_of(jstate.opt_state))) if int(jstate.step)
            else None),
        "ema": (convert.flax_to_state_dict(to_numpy(jstate.ema_params))
                if jstate.ema_params is not None else None),
    }


def run_both(jax_cfg, cfg, num_steps):
    """Step both from the JAX init, the port synced to the JAX state before
    each step; per step: the state before, both states after and both
    metrics."""
    state, spec, model, tx = jax_train.create_state(jax_cfg)
    jstep = jax_train.make_train_step(model, spec, jax_cfg, tx)
    tstate, tspec = train.create_state(
        cfg, device="cpu",
        variables=(to_numpy(state.params), to_numpy(state.batch_stats)))
    tstep = train.make_train_step(tspec, cfg)
    rng = np.random.default_rng(0)
    steps = []
    for _ in range(num_steps):
        batch = make_batch(rng, cfg)
        sync_from_jax(tstate, state)
        before = jax_snapshot(state)
        state, jm = jstep(state, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
        tstate, tm = tstep(tstate, train.batch_to_device(batch, "cpu"))
        steps.append({
            "before": before, "jax": jax_snapshot(state),
            "port": snapshot(tstate),
            "jax_metrics": {k: float(v) for k, v in jm.items()},
            "port_metrics": {k: float(v) for k, v in tm.items()},
            "steps": (int(state.step), tstate.step)})
    return steps


@pytest.fixture(scope="module")
def graft_run():
    return run_both(jax_config.TrainConfig(**GRAFT),
                    config_lib.TrainConfig(**GRAFT), 3)


@pytest.fixture(scope="module")
def mpii_run():
    return run_both(jax_config.get_config("mpii_rank1_224", **MPII_DEFAULTS),
                    config_lib.get_config("mpii_rank1_224", **MPII_DEFAULTS),
                    2)


RUNS = ["graft_run", "mpii_run"]


def l2_rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def assert_changes_close(step, what, leaf_tol, total_tol):
    """The change of each leaf over the step (after - before), in L2
    relative to JAX's, per leaf and over all leaves."""
    got, want, before = step["port"][what], step["jax"][what], \
        step["before"][what]
    assert set(got) == set(want)
    sq_err = sq_ref = 0.0
    for k, w in want.items():
        b = before[k]
        assert got[k].shape == w.shape, k
        d_got, d_want = got[k].detach() - b, w - b
        assert l2_rel(d_got, d_want) < leaf_tol, f"{what} {k}"
        sq_err += float(((d_got - d_want) ** 2).sum())
        sq_ref += float((d_want ** 2).sum())
    assert (sq_err / sq_ref) ** 0.5 < total_tol, what


@pytest.mark.parametrize("run", RUNS)
def test_metrics_match_jax(run, request):
    for i, step in enumerate(request.getfixturevalue(run)):
        got, want = step["port_metrics"], step["jax_metrics"]
        assert set(got) == set(want)
        for k, w in want.items():
            tol = 1e-2 if k == "grad_norm" else (1e-4 if i == 0 else 1e-3)
            assert np.isfinite(got[k])
            assert abs(got[k] - w) <= tol * abs(w), (i, k, got[k], w)
        assert step["steps"] == (i + 1, i + 1)


@pytest.mark.parametrize("run", RUNS)
def test_params_match_jax(run, request):
    for step in request.getfixturevalue(run):
        assert_changes_close(step, "params", 0.5, 0.1)


@pytest.mark.parametrize("run", RUNS)
def test_bn_running_stats_match_jax(run, request):
    """Flax moves running_var toward the biased batch variance."""
    for step in request.getfixturevalue(run):
        got, want = step["port"]["stats"], step["jax"]["stats"]
        assert set(got) == set(want)
        for k, w in want.items():
            d_got = got[k] - step["before"]["stats"][k]
            d_want = w - step["before"]["stats"][k]
            assert float(d_want.abs().max()) > 0, k    # BN in train mode
            err = float((d_got - d_want).abs().max() / d_want.abs().max())
            assert err < 1e-2, f"{k}: {err:.2e}"


@pytest.mark.parametrize("run", RUNS)
def test_momentum_buffers_match_jax(run, request):
    for step in request.getfixturevalue(run):
        got, want = step["port"]["momentum"], step["jax"]["momentum"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert l2_rel(got[k], w) < 0.2, k
        total = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
        ref = sum(float((w ** 2).sum()) for w in want.values())
        assert (total / ref) ** 0.5 < 0.1


def test_ema_matches_jax(graft_run):
    for step in graft_run:
        assert_changes_close(step, "ema", 0.5, 0.1)


def test_freeze_bn_keeps_running_stats_bit_equal():
    """freeze_bn: batch norm in eval mode through train() (the step calls
    model.train()), gradients still reach its scale and offset."""
    cfg = config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", pooling="attention",
        image_size=64, batch_size=2, bf16_backbone=False,
        learning_rate=1e-3, lr_schedule="constant", freeze_bn=True)
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=393, num_positions=4, seed=3)
    state, spec = train.create_state(cfg, device="cpu",
                                     variables=(params, stats))
    before = {k: v.clone() for k, v in state.model.state_dict().items()
              if "running" in k}
    bn_w = state.model.resnet.conv1_bn.weight.detach().clone()
    step = train.make_train_step(spec, cfg)
    state, metrics = step(state, train.batch_to_device(
        make_batch(np.random.default_rng(1), cfg), "cpu"))
    assert np.isfinite(float(metrics["loss/total"]))
    assert state.model.resnet.conv1_bn.training is False
    for k, v in state.model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, before[k]), k
    assert not torch.equal(state.model.resnet.conv1_bn.weight, bn_w)


def test_indivisible_batch_is_a_loud_error():
    cfg = config_lib.TrainConfig(**GRAFT)
    step = train.make_train_step(train.get_dataset("mpii"), cfg)
    batch = {"image": torch.zeros(3, 64, 64, 3)}
    with pytest.raises(ValueError, match="grad_accum_steps"):
        step(None, batch)
