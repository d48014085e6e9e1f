"""The port's bfloat16 backbone (``bf16_backbone=True``) against the JAX
package's, on the CPU, from the same Flax-layout weights (carried across
by the weight bridge) and the same seeded numpy inputs: resnet_v1_50 at
64 px, batch 8.  The eval-mode features and logits, and one train step
(the losses, ``grad_norm``, the gradients as the first step's momentum
buffers, the BN running statistics' changes), with batch norm in train
mode, with ``freeze_bn``, and with pose attention.

Each side's own gap, bfloat16 against float32 on the same inputs, is
measured in the same test (``precision.py --mode bf16`` measures the
port's at full width).  Two independent bfloat16 roundings of one
float32 computation differ by up to about sqrt(2) times either's gap, so:

  * ``rel(port_bf16, jax_bf16) <= 2 * max(gap_jax, gap_port)``, L2 for
    tensors;
  * ``0.5 <= gap_port / gap_jax <= 2`` for the tensors: a port that
    quietly stays in float32, or rounds where JAX does not, lands outside;
  * the backbone's output is bfloat16, the features, the logits, the
    parameters and their gradients float32.

Train-mode batch norm of a random-init ResNet is chaotic: bfloat16 moves
its features ~45% from float32 on both sides (see PERF.md), so there
the rule is loose by nature; in eval mode and with ``freeze_bn`` the
gaps are ~1%.  Torch's own batch norm on a bfloat16 input computes in
float32 as Flax's does.  A checkpoint holds float32 parameters whichever
dtype trained it, and restores bit for bit across ``bf16_backbone``
values.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.models.resnet import BatchNorm
from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import train as jax_train

torch.set_num_threads(2)
SIZE, BATCH = 64, 8
BASE = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
            rank=1, image_size=SIZE, batch_size=BATCH, learning_rate=1e-3,
            lr_schedule="constant", weight_decay=0.0, grad_clip_norm=None)
VARIANTS = {"train_bn": {}, "freeze_bn": {"freeze_bn": True},
            "pose": {"pooling": "pose_attention", "freeze_bn": True}}


def perturbed_variables(pooling, seed=0):
    """Seeded Flax-layout variables whose BN scales, offsets and running
    statistics are not the init values, so that eval-mode batch norm
    does work."""
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=393, rank=1, num_positions=4,
        pooling=pooling, seed=seed)
    rng = np.random.default_rng(seed + 1)

    def walk(tree, bn):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, k.endswith("_bn"))
            elif bn and k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif bn and k in ("bias", "mean"):
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
    walk(params, False)
    walk(stats, False)
    return params, stats


def make_batch(pooling, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8),
             "label": rng.integers(0, 393, BATCH).astype(np.int32)}
    if pooling == "pose_attention":
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, BATCH), rng.uniform(0.8, 1.2, BATCH),
             rng.uniform(0, 8, BATCH), rng.uniform(0, 8, BATCH),
             (np.arange(BATCH) % 2).astype(np.float64)], 1).astype(
                 np.float32)
        batch["keypoints"] = rng.uniform(0, SIZE, (BATCH, 16, 2)).astype(
            np.float32)
        batch["visibility"] = (rng.uniform(size=(BATCH, 16)) > 0.2).astype(
            np.float32)
    return batch


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float64), tree)


def jax_side(kw, variables, batch, bf16):
    """JAX: the eval forward and one train step; the momentum buffer (the
    gradient) and the BN statistics' changes as flat float64 vectors."""
    cfg = jax_config.TrainConfig(**kw, bf16_backbone=bf16)
    model, tx = jax_train.build_model(cfg), jax_train.make_optimizer(cfg)
    params, stats = variables
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=tx.init(params), ema_params=None)
    spec = jax_train.get_dataset(cfg.dataset)
    images = jax_train.normalize_images(jnp.asarray(batch["image"]))
    out = model.apply({"params": params, "batch_stats": stats}, images,
                      train=False)
    step = jax_train.make_train_step(model, spec, cfg, tx)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    trace = [s.trace for s in jax.tree.leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)][0]
    momentum = convert.flax_to_state_dict(to_numpy(trace))
    after = convert.flax_to_state_dict({}, to_numpy(new.batch_stats))
    before = convert.flax_to_state_dict({}, to_numpy(stats))
    return {"features": np.asarray(out["features"], np.float64),
            "logits": np.asarray(out["logits"], np.float64),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "momentum": momentum,
            "stat_change": {k: after[k].numpy() - before[k].numpy()
                            for k in sorted(before)}}


def port_side(kw, variables, batch, bf16):
    """The port, the same quantities as :func:`jax_side`."""
    cfg = config_lib.TrainConfig(**kw, bf16_backbone=bf16)
    state, spec = train.create_state(cfg, device="cpu", variables=variables)
    model = state.model
    images = train.normalize_images(torch.from_numpy(batch["image"]))
    with torch.no_grad():
        backbone = model.resnet(images.permute(0, 3, 1, 2),
                                global_pool=False)
        out = model(images)
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    _, metrics = train.make_train_step(spec, cfg)(
        state, train.batch_to_device(batch, "cpu"))
    opt = state.optimizer
    return {"features": out["features"].double().numpy(),
            "logits": out["logits"].double().numpy(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "momentum": {n: opt.state[p]["momentum_buffer"]
                         for n, p in model.named_parameters()},
            "stat_change": {k: (model.state_dict()[k] - v).double().numpy()
                            for k, v in sorted(before.items())},
            "dtypes": {"backbone": backbone.dtype,
                       "features": out["features"].dtype,
                       "logits": out["logits"].dtype,
                       "params": {p.dtype for p in model.parameters()},
                       "grads": {p.grad.dtype for p in model.parameters()
                                 if p.grad is not None},
                       "stats": {v.dtype for k, v in
                                 model.state_dict().items()
                                 if "running" in k}},
            "pose": out.get("pose_heatmaps")}


def vector(side, what):
    v = side[what]
    if isinstance(v, dict):
        return np.concatenate([np.ravel(np.asarray(v[k], np.float64))
                               for k in sorted(v)])
    return np.ravel(v)


def rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def run(request):
    kw = {**BASE, **VARIANTS[request.param]}
    variables = perturbed_variables(kw["pooling"])
    batch = make_batch(kw["pooling"])
    sides = {(pkg, bf16): fn(kw, variables, batch, bf16)
             for pkg, fn in (("jax", jax_side), ("port", port_side))
             for bf16 in (False, True)}
    return request.param, kw, sides


TENSORS = ("features", "logits", "momentum", "stat_change")


def gaps(sides, get):
    """(gap_jax, gap_port, port vs JAX in bfloat16) of one quantity."""
    jb, jf = get(sides["jax", True]), get(sides["jax", False])
    pb, pf = get(sides["port", True]), get(sides["port", False])
    return rel(jb, jf), rel(pb, pf), rel(pb, jb)


def test_bf16_tensors_match_jax(run):
    name, kw, sides = run
    for what in TENSORS:
        if what == "stat_change" and kw.get("freeze_bn"):
            for side in sides.values():         # frozen: no change at all
                assert not np.any(vector(side, what)), (name, side)
            continue
        gap_jax, gap_port, diff = gaps(sides, lambda s: vector(s, what))
        assert gap_jax > 0 and gap_port > 0, (name, what)
        assert diff <= 2 * max(gap_jax, gap_port), \
            (name, what, diff, gap_jax, gap_port)
        assert 0.5 <= gap_port / gap_jax <= 2, \
            (name, what, gap_jax, gap_port)


def test_bf16_losses_and_grad_norm_match_jax(run):
    name, kw, sides = run
    keys = set(sides["jax", True]["metrics"])
    assert keys == set(sides["port", True]["metrics"])
    assert ("loss/pose" in keys) == (kw["pooling"] == "pose_attention")
    for k in keys:
        gap_jax, gap_port, diff = gaps(
            sides, lambda s: np.array([s["metrics"][k]]))
        assert np.isfinite(sides["port", True]["metrics"][k])
        assert diff <= 2 * max(gap_jax, gap_port), \
            (name, k, diff, gap_jax, gap_port)


def test_bf16_dtypes(run):
    name, kw, sides = run
    for bf16, compute in ((True, torch.bfloat16), (False, torch.float32)):
        d = sides["port", bf16]["dtypes"]
        assert d["backbone"] == compute, name
        assert d["features"] == d["logits"] == torch.float32, name
        assert d["params"] == d["grads"] == d["stats"] == {torch.float32}
        pose = sides["port", bf16]["pose"]
        assert pose is None or pose.dtype == torch.float32


@pytest.mark.parametrize("train_mode", [True, False])
def test_batch_norm_on_bf16_computes_in_float32(train_mode):
    """Torch's batch norm given a bfloat16 input and float32 parameters and
    statistics (``resnet.BatchNorm``) reduces and normalizes in float32
    and rounds once, as Flax's does: Flax's float32 formula (fast
    variance) rounded to bfloat16 gives the same outputs but for a few
    rounding flips of statistics summed in another order, where the
    formula in bfloat16 arithmetic differs on ~half of them.  The running
    statistics stay float32 and move toward the float32 batch ones."""
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm(64, eps=1e-5, momentum=0.003)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(generator=g)
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.5, 1.5, generator=g)
    bn.train(train_mode)
    x = (torch.randn(8, 64, 14, 14, generator=g) * 3 + 1).to(torch.bfloat16)
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x)
    xf = x.float()
    if train_mode:
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp(min=0)
        torch.testing.assert_close(bn.running_mean, mean0.lerp(mean, 0.003))
        torch.testing.assert_close(bn.running_var, var0.lerp(var, 0.003))
    else:
        mean, var = mean0, var0
    assert y.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    mul = (torch.rsqrt(var + 1e-5) * bn.weight)[None, :, None, None]
    mean, bias = mean[None, :, None, None], bn.bias[None, :, None, None]
    want = ((xf - mean) * mul + bias).to(torch.bfloat16)
    low = (x - mean.bfloat16()) * mul.bfloat16() + bias.bfloat16()
    assert (y != want).float().mean() <= 1e-2
    assert (low != want).float().mean() >= 0.3


@pytest.mark.parametrize("saved_bf16", [True, False])
def test_checkpoint_restores_across_bf16_backbone(saved_bf16):
    """A step trained in one compute dtype restores bit for bit into a
    state of the other: parameters, statistics and momentum are float32
    either way."""
    kw = dict(BASE, image_size=32, batch_size=2)
    variables = perturbed_variables("attention", seed=4)
    saved_cfg = config_lib.TrainConfig(**kw, bf16_backbone=saved_bf16)
    state, spec = train.create_state(saved_cfg, device="cpu",
                                     variables=variables)
    batch = make_batch("attention", seed=5)
    batch["image"] = batch["image"][:2, :32, :32]
    batch["label"] = batch["label"][:2]
    train.make_train_step(spec, saved_cfg)(
        state, train.batch_to_device(batch, "cpu"))
    with tempfile.TemporaryDirectory() as d:
        mgr = ckpt_lib.make_manager(d)
        ckpt_lib.save(mgr, state)
        other, _ = train.create_state(
            dataclasses.replace(saved_cfg, bf16_backbone=not saved_bf16),
            device="cpu")
        ckpt_lib.restore(mgr, other)
    assert other.step == state.step == 1
    assert other.model.resnet.dtype == (torch.float32 if saved_bf16
                                        else torch.bfloat16)
    want, got = state.model.state_dict(), other.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    named = dict(other.model.named_parameters())
    for n, p in state.model.named_parameters():
        assert torch.equal(
            other.optimizer.state[named[n]]["momentum_buffer"],
            state.optimizer.state[p]["momentum_buffer"]), n
