"""The port's checkpoints: save/restore of a live TrainState (model,
BN buffers, SGD momentum or AdamW moments, EMA, step) bitwise through
``torch.load(weights_only=True)``, pruning, atomic saves, the reading of
an Orbax step (and the rejection of an uncommitted one), and keep-best
retention in the four cases of ``tests/test_best_keeper.py``, with
``best_metric_of`` and ``manager_for_step``; and
``convert.state_dict_to_flax``, the inverse of the weight bridge that
``restore_for_eval`` uses.

A small model (a conv, a train-mode batch norm and the pooling head's
weights) stands in for the ResNet: the format does not depend on it, and
``tests/test_torch_train_resume.py`` saves and resumes the real one."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import orbax_checkpoint
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.models import get_model
from attentionalpoolingaction_torch.models.resnet import BatchNorm
from attentionalpoolingaction_tpu import checkpoint as jax_ckpt
from attentionalpoolingaction_tpu.train import TrainState as JaxTrainState

torch.set_num_threads(2)


class Small(nn.Module):
    def __init__(self, seed):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.resnet = nn.Module()
        self.resnet.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.resnet.add_module("conv1_bn", BatchNorm(4, momentum=0.1))
        self.head = nn.Module()
        for name, shape in (("attn_w", (4, 5, 1)), ("attn_b", (5, 1))):
            self.head.register_parameter(
                name, nn.Parameter(torch.randn(shape, generator=g)))
        with torch.no_grad():
            self.resnet.conv1.weight.copy_(
                torch.randn(self.resnet.conv1.weight.shape, generator=g))

    def forward(self, x):
        f = self.resnet.conv1_bn(self.resnet.conv1(x)).mean((2, 3))
        return f @ self.head.attn_w[..., 0] + self.head.attn_b[:, 0]


def small_state(seed, **kw):
    cfg = config_lib.TrainConfig(learning_rate=0.1, lr_schedule="constant",
                                 **kw)
    model = Small(seed).train()
    state = train.TrainState(
        step=0, model=model, optimizer=train.make_optimizer(cfg, model),
        ema_params=({n: p.detach().clone()
                     for n, p in model.named_parameters()}
                    if cfg.ema_decay else None))
    return state, cfg


def take_steps(state, cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    sched = train.make_learning_rate(cfg)
    for _ in range(n):
        state.optimizer.zero_grad()
        state.model(torch.randn(2, 3, 6, 6, generator=g)).square().sum() \
            .backward()
        train.apply_gradients(state, cfg, sched)


def assert_states_equal(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and oa["state"]
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(ob["state"][i][k])), (i, k)
    assert (a.ema_params is None) == (b.ema_params is None)
    for n in a.ema_params or {}:
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n


@pytest.mark.parametrize("kw", [
    dict(optimizer="momentum"), dict(optimizer="momentum", ema_decay=0.9),
    dict(optimizer="adamw", ema_decay=0.99)],
    ids=["sgd", "sgd-ema", "adamw-ema"])
def test_save_restore_bitwise(tmp_path, kw):
    live, cfg = small_state(0, **kw)
    take_steps(live, cfg, 3)
    mgr = ckpt_lib.make_manager(tmp_path / "checkpoints")
    ckpt_lib.save(mgr, live)
    assert mgr.all_steps() == [3]
    # plain tensors, ints and dicts: the safe loader reads the file
    payload = torch.load(tmp_path / "checkpoints" / "3" / "state.pt",
                         weights_only=True)
    assert set(payload) == {"step", "model", "optimizer"} | (
        {"ema_params"} if cfg.ema_decay else set())
    fresh, _ = small_state(1, **kw)
    assert ckpt_lib.restore(mgr, fresh) is fresh
    assert_states_equal(fresh, live)
    # the restored state trains on exactly as the live one
    take_steps(live, cfg, 2, seed=5)
    take_steps(fresh, cfg, 2, seed=5)
    assert_states_equal(fresh, live)


def test_restore_needs_a_step_and_an_ema(tmp_path):
    mgr = ckpt_lib.make_manager(tmp_path)
    state, cfg = small_state(0)
    assert ckpt_lib.restore(mgr, state) is None
    assert ckpt_lib.restore_for_eval(mgr) is None
    assert ckpt_lib.saved_tree_keys(mgr) == set()
    ckpt_lib.save(mgr, state)
    with_ema, _ = small_state(0, ema_decay=0.9)
    with pytest.raises(ValueError, match="no ema_params"):
        ckpt_lib.restore(mgr, with_ema)


def test_pruning_and_leftover_tmp(tmp_path):
    mgr = ckpt_lib.make_manager(tmp_path, max_to_keep=2)
    state, cfg = small_state(0)
    (tmp_path / "5.tmp").mkdir()              # an interrupted save
    (tmp_path / "5.tmp" / "state.pt").write_bytes(b"partial")
    (tmp_path / "notes").mkdir()
    for _ in range(4):
        take_steps(state, cfg, 1)
        ckpt_lib.save(mgr, state)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    state.step = 5
    ckpt_lib.save(mgr, state)                 # over the leftover 5.tmp
    assert mgr.all_steps() == [4, 5]
    assert not (tmp_path / "5.tmp").exists()
    # the same step again is refused, and leaves the saved one whole
    with pytest.raises(ValueError, match="already saved"):
        ckpt_lib.save(mgr, state)
    assert mgr.all_steps() == [4, 5]
    assert ckpt_lib.restore_for_eval(mgr).step == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "5", "notes"]


def test_restore_for_eval_gives_flax_layout(tmp_path):
    state, cfg = small_state(0, ema_decay=0.9)
    take_steps(state, cfg, 2)
    mgr = ckpt_lib.make_manager(tmp_path)
    ckpt_lib.save(mgr, state)
    ev = ckpt_lib.restore_for_eval(mgr)
    assert ev.step == 2
    w = state.model.resnet.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(ev.params["resnet"]["conv1"]["kernel"],
                                  w.transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(
        ev.batch_stats["resnet"]["conv1_bn"]["var"],
        state.model.resnet.conv1_bn.running_var.numpy())
    np.testing.assert_array_equal(
        ev.ema_params["head"]["attn_w"],
        state.ema_params["head.attn_w"].numpy())
    assert ckpt_lib.saved_tree_keys(mgr) == {"step", "model", "optimizer",
                                             "ema_params"}


def _jax_state(step: int, tag: float) -> JaxTrainState:
    return JaxTrainState(
        step=jnp.asarray(step, jnp.int32),
        params={"w": jnp.full((3,), tag, jnp.float32)},
        batch_stats={"m": jnp.zeros((2,))},
        opt_state={"mu": jnp.zeros((3,))},
    )


def test_orbax_step_is_rejected(tmp_path):
    """A committed step the JAX package wrote (Orbax) is read
    (``orbax_checkpoint.py``): listed, its keys and tree read; a tree that
    is not an ActionModel's raises ``KeyError`` and leaves the live state
    as it was.  Without its ``_CHECKPOINT_METADATA`` the step is rejected:
    not listed, and a load names it uncommitted."""
    mgr = jax_ckpt.make_manager(str(tmp_path / "checkpoints"))
    jax_ckpt.save(mgr, _jax_state(4, 1.0))
    mgr.wait_until_finished()
    port = ckpt_lib.make_manager(tmp_path / "checkpoints")
    assert port.latest_step() == 4
    assert ckpt_lib.saved_tree_keys(port) == {"step", "model", "optimizer"}
    tree = orbax_checkpoint.read_tree(port.step_dir(4))
    assert int(tree["step"]) == 4
    assert np.array_equal(tree["params"]["w"], np.full(3, 1.0, np.float32))
    with pytest.raises(KeyError, match="params/w"):
        ckpt_lib.restore_for_eval(port)
    state, _ = small_state(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(KeyError, match="params/w"):
        ckpt_lib.restore(port, state)
    assert all(torch.equal(before[k], v)
               for k, v in state.model.state_dict().items())
    (port.step_dir(4) / orbax_checkpoint.COMMIT_FILE).unlink()
    assert port.all_steps() == []
    with pytest.raises(ValueError, match="not committed"):
        port.load(4, "cpu")
    (tmp_path / "checkpoints" / "9").mkdir()
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        ckpt_lib.restore_for_eval(port, step=9)


# -- keep-best: the four cases of tests/test_best_keeper.py --------------------

def _tagged(step: int, tag: float):
    state, _ = small_state(0)
    with torch.no_grad():
        state.model.head.attn_b.fill_(tag)
    state.step = step
    return state


def test_best_keeper_survives_pruning(tmp_path):
    workdir = str(tmp_path)
    mgr = ckpt_lib.make_manager(workdir + "/checkpoints", max_to_keep=2)
    keeper = ckpt_lib.BestKeeper(workdir)
    metrics = {1: 0.1, 2: 0.5, 3: 0.9, 4: 0.4, 5: 0.2}  # peak at step 3
    saved = []
    for step, m in metrics.items():
        state = _tagged(step, float(step))
        ckpt_lib.save(mgr, state)
        saved.append(keeper.update(step, {"mAP": m, "accuracy": 0.0},
                                   state))
    mgr.wait_until_finished()
    keeper.wait_until_finished()

    assert saved == [True, True, True, False, False]
    assert 3 not in mgr.all_steps()
    assert keeper.best() == {"step": 3, "metric": "mAP", "value": 0.9}
    best_mgr, step = ckpt_lib.manager_for_step(workdir, "best")
    restored = ckpt_lib.restore_for_eval(best_mgr, step=step)
    assert restored.step == 3
    np.testing.assert_array_equal(restored.params["head"]["attn_b"],
                                  np.full((5, 1), 3.0, np.float32))
    # numeric strings still address the rolling window
    mgr2, step2 = ckpt_lib.manager_for_step(workdir, "5")
    assert step2 == 5
    assert ckpt_lib.restore_for_eval(mgr2, step=step2).step == 5


def test_best_keeper_resumes_ranking(tmp_path):
    workdir = str(tmp_path)
    k1 = ckpt_lib.BestKeeper(workdir)
    assert k1.update(2, {"accuracy": 0.8}, _tagged(2, 2.0))  # HMDB metric
    k2 = ckpt_lib.BestKeeper(workdir)                        # a restart
    assert not k2.update(3, {"accuracy": 0.7}, _tagged(3, 3.0))
    assert k2.update(4, {"accuracy": 0.9}, _tagged(4, 4.0))
    assert k2.best()["step"] == 4 and k2.best()["metric"] == "accuracy"


def test_best_keeper_stale_meta_self_heals(tmp_path):
    workdir = str(tmp_path)
    k = ckpt_lib.BestKeeper(workdir)
    os.makedirs(str(k.dir), exist_ok=True)
    k._meta.write_text(json.dumps(
        {"step": 7, "metric": "mAP", "value": 0.95}))
    assert k.best() is None                      # stale meta ignored
    assert k.update(8, {"mAP": 0.4}, _tagged(8, 8.0))
    assert k.best() == {"step": 8, "metric": "mAP", "value": 0.4}
    restored = ckpt_lib.restore_for_eval(
        *ckpt_lib.manager_for_step(workdir, "best"))
    assert restored.step == 8


def test_best_keeper_meta_written_after_commit(tmp_path, monkeypatch):
    """Save first, meta after: when best.json appears, the step it names
    is committed; a save that fails leaves no meta."""
    k = ckpt_lib.BestKeeper(str(tmp_path))
    assert k.update(3, {"mAP": 0.6}, _tagged(3, 3.0))
    assert k.best() == {"step": 3, "metric": "mAP", "value": 0.6}
    assert 3 in k._mgr.all_steps()
    restored = ckpt_lib.restore_for_eval(
        *ckpt_lib.manager_for_step(str(tmp_path), "best"))
    assert restored.step == 3

    def failing_save(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "save", failing_save)
    with pytest.raises(OSError):
        k.update(4, {"mAP": 0.7}, _tagged(4, 4.0))
    assert k.best() == {"step": 3, "metric": "mAP", "value": 0.6}


def test_best_metric_of():
    assert ckpt_lib.best_metric_of({"mAP": 0.3, "accuracy": 0.9}) == \
        ("mAP", 0.3)
    assert ckpt_lib.best_metric_of({"accuracy": 0.9}) == ("accuracy", 0.9)
    assert ckpt_lib.best_metric_of({"mAP": float("nan"),
                                    "accuracy": 0.5}) == ("accuracy", 0.5)
    with pytest.raises(ValueError, match="no rankable metric"):
        ckpt_lib.best_metric_of({"num_examples": 5})


@pytest.mark.parametrize("step, want_dir, want_step", [
    (None, "checkpoints", None), (7, "checkpoints", 7),
    ("12", "checkpoints", 12), ("best", "checkpoints_best", None),
    (" BEST ", "checkpoints_best", None)])
def test_manager_for_step(tmp_path, step, want_dir, want_step):
    mgr, got = ckpt_lib.manager_for_step(str(tmp_path), step)
    assert mgr.directory == tmp_path / want_dir
    assert got == want_step


@pytest.mark.parametrize("pooling", ["avg", "attention", "pose_attention"])
def test_state_dict_to_flax_round_trip(pooling):
    """``state_dict_to_flax`` inverts the weight bridge bitwise, and gives
    the Flax tree's structure and shapes."""
    model = get_model("resnet_v1_50", num_classes=7, pooling=pooling, rank=2,
                      image_size=64, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    params, stats = convert.state_dict_to_flax(sd)
    back = convert.flax_to_state_dict(params, stats)
    assert back.keys() == {k for k in sd
                           if not k.endswith("num_batches_tracked")}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    if pooling != "avg":
        want_p, want_s = convert.random_flax_variables(
            "resnet_v1_50", num_classes=7, rank=2, num_positions=4,
            pooling=pooling)
        for got, want in ((params, want_p), (stats, want_s)):
            fg, fw = ckpt_lib._flatten(got), ckpt_lib._flatten(want)
            assert fg.keys() == fw.keys()
            assert all(fg[k].shape == fw[k].shape for k in fw)
    with pytest.raises(KeyError, match="no Flax variable"):
        convert.state_dict_to_flax({"head.extra": torch.zeros(1)})
