"""The pieces of the port's train step vs the JAX package's, on the same
numpy inputs, on the CPU: the learning-rate schedules, the weight-decay
groups, the optimizer update (clip, decay, SGD momentum or AdamW) and
the EMA on the same gradients, both classification losses, the pose
targets and heatmap functions, batch norm in train mode, the Flax-like
init, and the ``train`` loop.

Tolerances: 1e-5 relative (of each leaf's largest magnitude for tensors):
the same float32 arithmetic in another order, a few ulps, and optax's
schedules computed in float32 against the port's float64; 1e-6 for the
running statistics of one batch norm layer (the unbiased variance would
be off by 3e-4 here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as flax_nn
from torch import nn

from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.ops import heatmap as jax_hm
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.models import get_model
from attentionalpoolingaction_torch.models.resnet import BatchNorm
from attentionalpoolingaction_torch.ops import heatmap as hm

torch.set_num_threads(2)


def rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


# -- schedules ----------------------------------------------------------------

@pytest.mark.parametrize("schedule, warmup", [
    ("constant", 0), ("constant", 5), ("cosine", 0), ("cosine", 5),
    ("exponential", 0), ("exponential", 5)])
def test_learning_rate_matches_optax(schedule, warmup):
    kw = dict(lr_schedule=schedule, warmup_steps=warmup, num_steps=40,
              learning_rate=0.1, lr_decay_steps=7, lr_decay_rate=0.5)
    want = jax_train.make_learning_rate(
        jax_config.get_config("mpii_rank1_224", **kw))
    got = train.make_learning_rate(
        config_lib.get_config("mpii_rank1_224", **kw))
    for step in range(50):
        w = float(want(step))
        # abs: float32 cos near pi in optax, 1e-6 of the peak rate
        assert got(step) == pytest.approx(w, rel=1e-5, abs=1e-7), step


# -- decay groups -------------------------------------------------------------

def test_decay_mask_matches_jax():
    """The port's decay flags by parameter name equal the JAX package's
    ``_decay_mask`` on the same Flax tree, carried by the weight bridge."""
    params, _ = convert.random_flax_variables(
        "resnet_v1_50", num_classes=5, rank=2, num_positions=4,
        pooling="pose_attention")
    mask = jax_train._decay_mask(params)
    as_arrays = jax.tree.map(lambda m, p: np.full(p.shape, float(m)),
                             mask, params)
    want = {k: bool(v.flatten()[0])
            for k, v in convert.flax_to_state_dict(as_arrays).items()}
    model = get_model("resnet_v1_50", num_classes=5, pooling="pose_attention",
                      rank=2, image_size=64, device="cpu")
    got = train.decay_mask(model)
    assert got == want
    assert got["head.attn_w"] and got["head.sal_w"]
    assert not got["head.attn_b"] and not got["resnet.conv1_bn.weight"]
    assert got["pose_head.pose_conv.weight"]
    assert not got["pose_head.pose_conv.bias"]
    avg = train.decay_mask(get_model("resnet_v1_50", num_classes=5,
                                     pooling="avg", device="cpu"))
    assert avg["head.logits.weight"] and not avg["head.logits.bias"]


# -- the update on the same gradients -----------------------------------------

class Tiny(nn.Module):
    """One conv, one batch norm and the pooling head's four weights, under
    the names the weight bridge gives the Flax tree of :func:`tiny_tree`."""

    def __init__(self):
        super().__init__()
        self.resnet = nn.Module()
        self.resnet.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.resnet.add_module("conv1_bn", nn.BatchNorm2d(4))
        self.head = nn.Module()
        for name, shape in (("attn_w", (4, 5, 2)), ("attn_b", (5, 2)),
                            ("sal_w", (4, 2)), ("sal_b", (2,))):
            self.head.register_parameter(name,
                                         nn.Parameter(torch.zeros(shape)))


def tiny_tree(rng, scale=1.0):
    def r(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"resnet": {"conv1": {"kernel": r(3, 3, 3, 4)},
                       "conv1_bn": {"scale": r(4), "bias": r(4)}},
            "head": {"attn_w": r(4, 5, 2), "attn_b": r(5, 2),
                     "sal_w": r(4, 2), "sal_b": r(2)}}


@pytest.mark.parametrize("kw", [
    dict(optimizer="momentum", lr_schedule="exponential", lr_decay_steps=2,
         lr_decay_rate=0.5, warmup_steps=1, grad_clip_norm=10.0),
    dict(optimizer="momentum", lr_schedule="constant", grad_clip_norm=None,
         ema_decay=0.999),
    dict(optimizer="adamw", lr_schedule="cosine", num_steps=5,
         grad_clip_norm=3.0, ema_decay=0.9),
], ids=["sgd-clip-warmup", "sgd-noclip-ema", "adamw-clip-ema"])
def test_update_matches_optax_on_same_grads(kw):
    """Three updates from the same gradients: global-norm clip (optax's
    min(1, max/|g|), no epsilon), decayed weights masked as
    ``_decay_mask``, SGD momentum or AdamW, the schedule at the count of
    earlier updates, and the EMA min(decay, (1+t)/(10+t))."""
    kw = dict(learning_rate=0.1, weight_decay=0.01, **kw)
    jcfg = jax_config.TrainConfig(**kw)
    cfg = config_lib.TrainConfig(**kw)
    rng = np.random.default_rng(0)
    params = tiny_tree(rng)
    tx = jax_train.make_optimizer(jcfg)
    opt_state = tx.init(params)
    ema = params

    model = Tiny()
    named = dict(model.named_parameters())
    with torch.no_grad():
        for n, t in convert.flax_to_state_dict(params).items():
            named[n].copy_(t)
    state = train.TrainState(
        step=0, model=model, optimizer=train.make_optimizer(cfg, model),
        ema_params=({n: p.detach().clone() for n, p in named.items()}
                    if cfg.ema_decay else None))
    schedule = train.make_learning_rate(cfg)

    for step, scale in enumerate((5.0, 0.3, 2.0)):      # clip on, off, on
        grads = tiny_tree(rng, scale)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if cfg.ema_decay:
            t = np.float32(step + 1)
            d = np.minimum(np.float32(cfg.ema_decay), (1 + t) / (10 + t))
            ema = jax.tree.map(lambda e, p: e * d + p * (1 - d), ema, params)
        for n, g in convert.flax_to_state_dict(grads).items():
            named[n].grad = g
        norm = train.apply_gradients(state, cfg, schedule)
        assert float(norm) == pytest.approx(
            float(optax.global_norm(grads)), rel=1e-5)
        for n, w in convert.flax_to_state_dict(params).items():
            assert rel(named[n], w) < 1e-5, (step, n)
        if cfg.ema_decay:
            for n, w in convert.flax_to_state_dict(ema).items():
                assert rel(state.ema_params[n], w) < 1e-5, (step, n)
    assert state.step == 3


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_loss_matches_jax(smoothing, masked):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    want = jax_train.classification_loss(
        jnp.asarray(logits), jnp.asarray(labels), multi_label=False,
        label_smoothing=smoothing,
        mask=None if mask is None else jnp.asarray(mask))
    got = train.classification_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        multi_label=False, label_smoothing=smoothing,
        mask=None if mask is None else torch.from_numpy(mask))
    assert rel(got, want) < 1e-5


def test_sigmoid_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 9)).astype(np.float32) * 4
    labels = (rng.uniform(size=(4, 9)) > 0.7).astype(np.float32)
    want = jax_train.classification_loss(
        jnp.asarray(logits), jnp.asarray(labels), multi_label=True)
    got = train.classification_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), multi_label=True)
    assert rel(got, want) < 1e-5


# -- pose targets and heatmaps ------------------------------------------------

def pose_batch(rng, b=4, size=64):
    return {
        "transform": np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(-4, 8, b), rng.uniform(-4, 8, b),
             (np.arange(b) % 2).astype(np.float64)], 1).astype(np.float32),
        "keypoints": rng.uniform(-5, size + 5, (b, 16, 2)).astype(np.float32),
        "visibility": (rng.uniform(size=(b, 16)) > 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("size", [64, 224])
def test_pose_targets_match_jax(size):
    batch = pose_batch(np.random.default_rng(size), size=size)
    wt, wv = jax_train.pose_targets(
        {k: jnp.asarray(v) for k, v in batch.items()}, image_size=size,
        num_joints=16)
    gt, gv = train.pose_targets(
        {k: torch.from_numpy(v) for k, v in batch.items()}, image_size=size)
    assert gt.shape == (4, train.feature_size(size),
                        train.feature_size(size), 17)
    assert rel(gt, wt) < 1e-5
    assert rel(gv, wv) == 0


def test_transform_keypoints_matches_jax():
    rng = np.random.default_rng(5)
    kps = rng.uniform(0, 100, (16, 2)).astype(np.float32)
    vis = (rng.uniform(size=16) > 0.5).astype(np.float32)
    for flip in (False, True):
        want = jax_hm.transform_keypoints(
            jnp.asarray(kps), jnp.asarray(vis), scale_y=0.9, scale_x=1.1,
            offset_y=3.0, offset_x=-2.0, flip=flip, width=80)
        got = hm.transform_keypoints(
            torch.from_numpy(kps), torch.from_numpy(vis), scale_y=0.9,
            scale_x=1.1, offset_y=3.0, offset_x=-2.0, flip=flip, width=80)
        assert rel(got[0], want[0]) < 1e-5
        assert rel(got[1], want[1]) == 0


def test_heatmaps_and_pose_loss_match_jax():
    rng = np.random.default_rng(6)
    kps = rng.uniform(-2, 9, (3, 16, 2)).astype(np.float32)   # some off-map
    vis = (rng.uniform(size=(3, 16)) > 0.3).astype(np.float32)
    want = jax_hm.render_gaussian_heatmaps(jnp.asarray(kps),
                                           jnp.asarray(vis), 7, 7, sigma=1.5)
    got = hm.render_gaussian_heatmaps(torch.from_numpy(kps),
                                      torch.from_numpy(vis), 7, 7, sigma=1.5)
    assert got.shape == (3, 7, 7, 16)
    assert rel(got, want) < 1e-5
    pred = rng.normal(size=(3, 7, 7, 16)).astype(np.float32)
    for v in (None, vis):
        w = jax_hm.pose_l2_loss(jnp.asarray(pred), want,
                                None if v is None else jnp.asarray(v))
        g = hm.pose_l2_loss(torch.from_numpy(pred), got,
                            None if v is None else torch.from_numpy(v))
        assert rel(g, w) < 1e-5


# -- batch norm and init ------------------------------------------------------

def test_batch_norm_train_mode_matches_flax():
    """Normalized by the batch's biased variance; the running variance
    moves toward that same biased variance (``nn.BatchNorm2d`` uses the
    unbiased one); gradients to input, scale and offset."""
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 3, 3, 5)) * 2 + 1).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(size=5).astype(np.float32)
    mean0 = rng.normal(size=5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.997,
                           epsilon=1e-5)

    def f(x, scale, bias):
        y, upd = bn.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}},
            x, mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd["batch_stats"])

    (_, (wy, wstats)), wgrads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(x, scale, bias)

    m = BatchNorm(5, eps=1e-5, momentum=1 - 0.997).train()
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_()
    y = m(xt)
    (y * torch.from_numpy(gy).permute(0, 3, 1, 2)).sum().backward()
    assert rel(y.permute(0, 2, 3, 1), wy) < 1e-5
    assert rel(m.running_mean, wstats["mean"]) < 1e-6
    assert rel(m.running_var, wstats["var"]) < 1e-6
    assert rel(xt.grad.permute(0, 2, 3, 1), wgrads[0]) < 1e-5
    assert rel(m.weight.grad, wgrads[1]) < 1e-5
    assert rel(m.bias.grad, wgrads[2]) < 1e-5
    m.eval()
    with torch.no_grad():
        ye = m(xt)
    want = ((x - m.running_mean.numpy()) / np.sqrt(m.running_var.numpy()
                                                   + 1e-5) * scale + bias)
    assert rel(ye.permute(0, 2, 3, 1), want) < 1e-5


def test_init_draws_flax_lecun_normal():
    """Convs and dense kernels: lecun_normal, std fan_in^-1/2 within 5%
    (torch's default gives 1/sqrt(3) of it), biases zero; one seed, the
    same weights."""
    def build(pooling, seed=0):
        return get_model("resnet_v1_50", num_classes=393, pooling=pooling,
                         image_size=64, device="cpu",
                         generator=torch.Generator().manual_seed(seed))

    model = build("pose_attention")
    avg = build("avg")
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    assert len(convs) == 54                 # 53 in the backbone, pose_conv
    for m in convs + [avg.head.logits]:
        w = m.weight.detach()
        fan_in = w[0].numel()
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.05, m
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
        if m.bias is not None:
            assert not m.bias.any()
    again = build("pose_attention")
    for (n, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    other = build("pose_attention", seed=1)
    assert not torch.equal(model.resnet.conv1.weight,
                           other.resnet.conv1.weight)


# -- the loop -----------------------------------------------------------------

def small_cfg(**kw):
    return config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", pooling="attention",
        image_size=64, batch_size=2, bf16_backbone=False,
        learning_rate=1e-3, lr_schedule="constant", log_every=2, **kw)


def test_train_loop_logs_and_calls_hooks():
    rng = np.random.default_rng(8)

    def batches():
        while True:
            yield {"image": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
                   "label": rng.integers(0, 393, 2).astype(np.int32)}

    seen = []
    state, history = train.train(
        small_cfg(), train_iter=batches(), num_steps=3, device="cpu",
        hooks=[lambda step, st, m: seen.append((step, type(m["loss/total"])))])
    assert state.step == 3
    assert [h["step"] for h in history] == [2, 3]
    assert all(np.isfinite(h["loss/total"]) and np.isfinite(h["grad_norm"])
               for h in history)
    # metrics reach the host only on logged steps
    assert seen == [(1, torch.Tensor), (2, float), (3, float)]


@pytest.mark.parametrize("kw, where", [
    (dict(mesh_shape=(2,)), "step"), (dict(zero1=True), "step"),
    (dict(remat_units=True), "step"), (dict(mesh_shape=(8,)), "train")])
def test_unported_options_raise(kw, where):
    """None of these options raises any more.  ``remat_units`` is ported
    (tests/test_torch_remat.py): its step runs.  A mesh and ZeRO-1 are
    ported (tests/test_torch_mesh.py); in one process (no process group)
    the step and ``train`` run without a mesh where JAX's ``train``
    builds none on one device: BASELINE config #5's ``mesh_shape=(8,)``
    trains alone, as one device's step."""
    cfg = dataclasses.replace(small_cfg(), **kw)
    spec = train.get_dataset("mpii")
    rng = np.random.default_rng(3)
    batch = {"image": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
             "label": rng.integers(0, 393, 2).astype(np.int32)}
    if where == "step":
        init = {"variables": convert.random_flax_variables(
            "resnet_v1_50", num_classes=393, num_positions=4)}
        state, _ = train.create_state(cfg, device="cpu", **init)
        assert state.mesh is None and state.plan is None
        train.make_train_step(spec, cfg)(state,
                                         train.batch_to_device(batch, "cpu"))
    else:
        init = {}
        state, _ = train.train(cfg, train_iter=iter([batch]), num_steps=1,
                               device="cpu")
    alone, _ = train.create_state(small_cfg(), device="cpu", **init)
    train.make_train_step(spec, small_cfg())(
        alone, train.batch_to_device(batch, "cpu"))
    for (k, a), b in zip(alone.model.state_dict().items(),
                         state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
