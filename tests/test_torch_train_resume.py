"""The port's checkpointed ``train`` on the CPU: an uninterrupted run
equals a run stopped at step k and resumed, bitwise (parameters, BN
statistics, momentum, step), with a staircase schedule whose decay
boundary falls after k; a real SIGTERM sent from a hook checkpoints that
step and returns; the EMA toggled between the saved run and the resumed
one; a stateful iterator's state saved, restored and collected with the
steps; ``init_checkpoint`` from a directory of the port's checkpoints.

resnet_v1_50 at 64 px, batch 2.  Checkpoints go to temporary directories
removed at the end of each test (a step of this model is ~190 MB)."""

import dataclasses
import json
import logging
import os
import signal
import tempfile
import threading

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import train

torch.set_num_threads(2)


@pytest.fixture
def workdir():
    with tempfile.TemporaryDirectory() as d:
        yield d


def small_cfg(**kw):
    base = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
                image_size=64, batch_size=2, bf16_backbone=False,
                learning_rate=0.05, lr_schedule="exponential",
                lr_decay_steps=3, lr_decay_rate=0.5, log_every=1,
                checkpoint_every=2, max_checkpoints=2)
    base.update(kw)
    return config_lib.TrainConfig(**base)


def make_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.integers(0, 256, (2, 64, 64, 3), np.uint8),
             "label": rng.integers(0, 393, 2).astype(np.int32)}
            for _ in range(n)]


def snapshot(state):
    opt = state.optimizer
    named = dict(state.model.named_parameters())
    return {
        "step": state.step,
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "momentum": {n: opt.state[p]["momentum_buffer"].clone()
                     for n, p in named.items() if p in opt.state},
        "ema": (None if state.ema_params is None else
                {n: t.clone() for n, t in state.ema_params.items()}),
    }


def assert_bitwise(a, b):
    assert a["step"] == b["step"]
    for part in ("model", "momentum", "ema"):
        if a[part] is None or b[part] is None:
            assert a[part] is b[part] is None, part
            continue
        assert a[part].keys() == b[part].keys() and a[part], part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def manager(workdir, cfg):
    return ckpt_lib.make_manager(os.path.join(workdir, "checkpoints"),
                                 max_to_keep=cfg.max_checkpoints)


def test_stop_and_resume_equals_uninterrupted(workdir):
    """4 steps straight, against 2 steps stopped by the stop event plus a
    resumed call for 2 more; the schedule halves at step 3, so the resumed
    steps must key it on the restored step."""
    cfg = small_cfg()
    batches = make_batches(4)
    straight, _ = train.train(cfg, train_iter=iter(batches), num_steps=4,
                              device="cpu")
    want = snapshot(straight)
    del straight

    mgr = manager(workdir, cfg)
    stop = threading.Event()

    def stop_at_2(step, state, metrics):
        if step == 2:
            stop.set()

    first, hist1 = train.train(cfg, train_iter=iter(batches), num_steps=4,
                               device="cpu", checkpoint_manager=mgr,
                               stop_event=stop, hooks=[stop_at_2])
    assert first.step == 2 and [h["step"] for h in hist1] == [1, 2]
    assert mgr.all_steps() == [2]
    del first
    second, hist2 = train.train(cfg, train_iter=iter(batches[2:]),
                                num_steps=4, device="cpu",
                                checkpoint_manager=mgr)
    assert [h["step"] for h in hist2] == [3, 4]
    assert mgr.all_steps() == [2, 4]
    assert_bitwise(snapshot(second), want)
    assert train.make_learning_rate(cfg)(3) == 0.025


def test_sigterm_from_a_hook_checkpoints_that_step(workdir):
    if threading.current_thread() is not threading.main_thread():
        pytest.fail("train installs its SIGTERM handler on the main thread "
                    "only; this test must run there")
    cfg = small_cfg(checkpoint_every=100)
    mgr = manager(workdir, cfg)
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def terminate_at_2(step, state, metrics):
        seen.append(step)
        if step == 2:
            # the handler must be train's own, or the signal kills the test
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)

    state, history = train.train(cfg, train_iter=iter(make_batches(5)),
                                 num_steps=5, device="cpu",
                                 checkpoint_manager=mgr,
                                 hooks=[terminate_at_2])
    assert seen == [1, 2] and state.step == 2
    assert mgr.all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before
    restored = ckpt_lib.restore_for_eval(mgr)
    assert restored.step == 2
    np.testing.assert_array_equal(
        restored.params["head"]["attn_b"],
        state.model.head.attn_b.detach().numpy())


def test_ema_toggled_across_a_resume(workdir, caplog):
    batches = make_batches(3)
    off = small_cfg()
    mgr = manager(workdir, off)
    train.train(off, train_iter=iter(batches), num_steps=2, device="cpu",
                checkpoint_manager=mgr)
    assert "ema_params" not in ckpt_lib.saved_tree_keys(mgr)

    # off -> on: the EMA starts from the restored parameters
    on = dataclasses.replace(off, ema_decay=0.9)
    with caplog.at_level(logging.WARNING):
        state, _ = train.train(on, train_iter=iter([]), num_steps=2,
                               device="cpu", checkpoint_manager=mgr)
    assert "seeding EMA from the restored params" in caplog.text
    assert state.step == 2
    for n, p in state.model.named_parameters():
        assert torch.equal(state.ema_params[n], p), n
    state, _ = train.train(on, train_iter=iter(batches[2:]), num_steps=3,
                           device="cpu", checkpoint_manager=mgr)
    assert "ema_params" in ckpt_lib.saved_tree_keys(mgr, 3)
    ema3 = {n: t.clone() for n, t in state.ema_params.items()}

    # on -> off: the saved EMA is left unused and not saved again
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        state, _ = train.train(off, train_iter=iter(make_batches(1, 7)),
                               num_steps=4, device="cpu",
                               checkpoint_manager=mgr)
    assert "saved EMA will not be updated" in caplog.text
    assert state.ema_params is None and state.step == 4
    assert "ema_params" not in ckpt_lib.saved_tree_keys(mgr, 4)
    # and on again: restored from step 4, which has none, so seeded again
    state, _ = train.train(on, train_iter=iter([]), num_steps=4,
                           device="cpu", checkpoint_manager=mgr)
    assert not torch.equal(state.ema_params["head.attn_w"],
                           ema3["head.attn_w"])


class CountingIterator:
    """A stateful iterator over numbered batches: ``get_state`` gives the
    position of the next batch."""

    def __init__(self, batches):
        self.batches, self.pos, self.set_states = batches, 0, []

    def __iter__(self):
        return self

    def __next__(self):
        if self.pos == len(self.batches):
            raise StopIteration
        self.pos += 1
        return self.batches[self.pos - 1]

    def get_state(self):
        return {"pos": self.pos}

    def set_state(self, state):
        self.set_states.append(state)
        self.pos = state["pos"]


def test_iterator_state_saved_restored_and_collected(workdir):
    cfg = small_cfg(checkpoint_every=1, max_checkpoints=2)
    mgr = manager(workdir, cfg)
    batches = make_batches(5)
    it = CountingIterator(batches)
    train.train(cfg, train_iter=it, num_steps=3, device="cpu",
                checkpoint_manager=mgr)
    assert mgr.all_steps() == [2, 3]
    files = sorted(p.name for p in mgr.directory.glob("grain_iter_*"))
    assert files == ["grain_iter_2_p0.json", "grain_iter_3_p0.json"]
    assert json.loads((mgr.directory / files[1]).read_text()) == {"pos": 3}

    # the resumed run continues the stream where the saved one stopped;
    # the device prefetch has pulled ahead to the end of the five batches
    it2 = CountingIterator(batches)
    state, _ = train.train(cfg, train_iter=it2, num_steps=5, device="cpu",
                           checkpoint_manager=mgr)
    assert it2.set_states == [{"pos": 3}] and it2.pos == 5
    assert state.step == 5 and mgr.all_steps() == [4, 5]
    assert sorted(p.name for p in mgr.directory.glob("grain_iter_*")) == [
        "grain_iter_4_p0.json", "grain_iter_5_p0.json"]


def test_init_checkpoint_from_a_port_run_leaves_the_head_fresh(workdir):
    cfg = small_cfg()
    mgr = manager(workdir, cfg)
    prev, _ = train.train(cfg, train_iter=iter(make_batches(2)), num_steps=2,
                          device="cpu", checkpoint_manager=mgr)
    warm, _ = train.create_state(
        dataclasses.replace(cfg, init_checkpoint=str(mgr.directory),
                            seed=99), device="cpu")
    fresh, _ = train.create_state(dataclasses.replace(cfg, seed=99),
                                  device="cpu")
    got = warm.model.state_dict()
    for k, v in prev.model.state_dict().items():
        if k.startswith("resnet.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for k, v in fresh.model.state_dict().items():
        if k.startswith("head."):
            assert torch.equal(got[k], v), k
    assert not torch.equal(got["head.attn_w"],
                           prev.model.state_dict()["head.attn_w"])
    assert warm.step == 0
    empty = os.path.join(workdir, "empty")
    os.makedirs(empty)
    with pytest.raises(ValueError, match="no checkpoint steps"):
        train.create_state(dataclasses.replace(cfg, init_checkpoint=empty),
                           device="cpu")
