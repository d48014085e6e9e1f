"""Asynchronous checkpoint saves in the port (``checkpoint.py``; the JAX
package saves through Orbax with ``enable_async_checkpointing``).

``CheckpointManager.save`` copies the payload into host buffers kept from
save to save and returns; a background thread writes, syncs, renames and
prunes.  The gates:

* a save followed at once by a restore, by a second save, by in-place
  changes of the live state, and by the SIGTERM stop of ``train`` leaves
  whole steps, each equal bit for bit to the state when it was saved, and
  resume from the stop is bitwise;
* the directory lists committed steps only while a write is in flight;
* a failing background write raises at the next save, listing, restore
  or ``wait_until_finished``, once;
* ``BestKeeper`` never writes a ``best.json`` naming an uncommitted step;
* interpreter exit waits for the write in flight.

The small stand-in model of ``tests/test_torch_checkpoint.py``; the
SIGTERM run trains resnet_v1_50 at 64 px as
``tests/test_torch_train_resume.py`` does."""

import copy
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading

import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import train

from test_torch_checkpoint import assert_states_equal, small_state, take_steps
from test_torch_train_resume import (
    assert_bitwise,
    make_batches,
    small_cfg,
    snapshot,
)

torch.set_num_threads(2)


class HeldWrites:
    """Hold every background write of the managers until ``release``."""

    def __init__(self, monkeypatch):
        self.go = threading.Event()
        self.started = threading.Event()
        real = ckpt_lib.CheckpointManager._write

        def held(mgr, step, payload):
            self.started.set()
            assert self.go.wait(timeout=60)
            real(mgr, step, payload)

        monkeypatch.setattr(ckpt_lib.CheckpointManager, "_write", held)

    def release(self):
        self.go.set()


def fresh_like(kw, seed=1):
    return small_state(seed, **kw)[0]


@pytest.mark.parametrize("kw", [dict(optimizer="momentum"),
                                dict(optimizer="adamw", ema_decay=0.99)],
                         ids=["sgd", "adamw-ema"])
def test_save_then_restore_at_once(tmp_path, kw, monkeypatch):
    live, cfg = small_state(0, **kw)
    take_steps(live, cfg, 2)
    held = HeldWrites(monkeypatch)
    mgr = ckpt_lib.make_manager(tmp_path)
    ckpt_lib.save(mgr, live)
    assert held.started.wait(timeout=60)
    # in flight: not listed, a .tmp at most
    assert mgr._listed_steps() == []
    assert not (tmp_path / "2").exists()
    want = fresh_like(kw, seed=0)
    take_steps(want, cfg, 2)
    # the live state moves on in place: the save holds its copy
    take_steps(live, cfg, 1, seed=9)
    threading.Timer(0.2, held.release).start()
    fresh = fresh_like(kw)
    assert ckpt_lib.restore(mgr, fresh) is fresh       # waits for the write
    assert_states_equal(fresh, want)
    assert mgr.all_steps() == [2]
    assert sorted(os.listdir(tmp_path)) == ["2"]


def test_save_then_save_again(tmp_path):
    live, cfg = small_state(0)
    mgr = ckpt_lib.make_manager(tmp_path, max_to_keep=2)
    wants = []
    for _ in range(3):
        take_steps(live, cfg, 1)
        ckpt_lib.save(mgr, live)
        wants.append(copy.deepcopy(live))
    buffers = {k: v.data_ptr() for k, v in mgr._host.items()}
    take_steps(live, cfg, 1)
    ckpt_lib.save(mgr, live)
    # the host buffers are allocated once and reused
    assert {k: v.data_ptr() for k, v in mgr._host.items()} == buffers
    mgr.wait_until_finished()
    assert mgr.all_steps() == [3, 4]
    fresh = fresh_like({})
    ckpt_lib.restore(mgr, fresh, step=3)
    assert_states_equal(fresh, wants[2])
    with pytest.raises(ValueError, match="already saved"):
        ckpt_lib.save(mgr, live)
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]


def test_failed_background_write_raises_at_the_next_call(tmp_path):
    state, cfg = small_state(0)
    take_steps(state, cfg, 1)
    d = tmp_path / "ckpt"
    mgr = ckpt_lib.make_manager(d)
    # an unwritable directory: a file where the directory was
    os.rmdir(d)
    d.write_text("not a directory")
    ckpt_lib.save(mgr, state)                 # queued: returns
    with pytest.raises(OSError):
        mgr.wait_until_finished()
    mgr.wait_until_finished()                 # raised once, not again
    for then in ("save", "all_steps", "restore"):
        ckpt_lib.save(mgr, state)
        with pytest.raises(OSError):
            if then == "save":
                ckpt_lib.save(mgr, state)
            elif then == "all_steps":
                mgr.all_steps()
            else:
                ckpt_lib.restore(mgr, fresh_like({}))
    mgr.wait_until_finished()


def test_failed_write_of_a_full_disk_raises(tmp_path, monkeypatch):
    state, cfg = small_state(0)
    take_steps(state, cfg, 1)

    def no_space(obj, f, *a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt_lib.torch, "save", no_space)
    mgr = ckpt_lib.make_manager(tmp_path)
    ckpt_lib.save(mgr, state)
    with pytest.raises(OSError, match="No space left"):
        ckpt_lib.restore(mgr, fresh_like({}))
    assert mgr.all_steps() == []
    assert os.listdir(tmp_path) == ["1.tmp"]  # the next save replaces it


def test_best_keeper_meta_names_committed_steps(tmp_path, monkeypatch):
    state, cfg = small_state(0)
    take_steps(state, cfg, 1)
    keeper = ckpt_lib.BestKeeper(tmp_path)
    held = HeldWrites(monkeypatch)
    threading.Timer(0.3, held.release).start()
    assert keeper.update(1, {"mAP": 0.5}, state)
    # update waited for the commit before it wrote the meta
    assert (tmp_path / "checkpoints_best" / "1" / "state.pt").is_file()
    assert keeper.best() == {"step": 1, "metric": "mAP", "value": 0.5}

    def fail(mgr, step, payload):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt_lib.CheckpointManager, "_write", fail)
    take_steps(state, cfg, 1)
    with pytest.raises(OSError):
        keeper.update(2, {"mAP": 0.7}, state)
    meta = json.loads((tmp_path / "checkpoints_best" / "best.json")
                      .read_text())
    assert meta["step"] == 1 and keeper.best()["step"] == 1


@pytest.fixture
def workdir():
    # not tmp_path: pytest keeps those, and a step here is ~190 MB
    with tempfile.TemporaryDirectory() as d:
        yield d


def test_sigterm_right_after_a_save_leaves_whole_steps(workdir):
    """Saves every step; SIGTERM from the hook of step 3 (the save of step
    2 may still be in flight): ``train`` saves step 3, waits for both
    writes and returns; resuming to step 4 equals the uninterrupted run
    bit for bit."""
    if threading.current_thread() is not threading.main_thread():
        pytest.fail("train installs its SIGTERM handler on the main thread "
                    "only; this test must run there")
    cfg = small_cfg(checkpoint_every=1, max_checkpoints=2)
    batches = make_batches(4)
    straight, _ = train.train(cfg, train_iter=iter(batches), num_steps=4,
                              device="cpu")
    want = snapshot(straight)
    del straight

    def terminate_at_3(step, state, metrics):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    directory = os.path.join(workdir, "checkpoints")
    mgr = ckpt_lib.make_manager(directory, max_to_keep=2)
    first, _ = train.train(cfg, train_iter=iter(batches), num_steps=4,
                           device="cpu", checkpoint_manager=mgr,
                           hooks=[terminate_at_3])
    assert first.step == 3
    # train returned after the commits: the directory is final on disk
    assert sorted(os.listdir(directory)) == ["2", "3"]
    stopped = snapshot(first)
    del first
    fresh, _ = train.create_state(cfg, device="cpu")
    ckpt_lib.restore(ckpt_lib.make_manager(directory), fresh)
    assert_bitwise(snapshot(fresh), stopped)
    del fresh
    second, _ = train.train(cfg, train_iter=iter(batches[3:]), num_steps=4,
                            device="cpu", checkpoint_manager=mgr)
    assert_bitwise(snapshot(second), want)
    assert mgr.all_steps() == [3, 4]


EXIT_SCRIPT = r'''
import sys, time
sys.path[:0] = [sys.argv[2], sys.argv[3]]
from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from test_torch_checkpoint import small_state, take_steps
real = ckpt_lib.CheckpointManager._write


def slow(mgr, step, payload):
    time.sleep(1.0)
    real(mgr, step, payload)


ckpt_lib.CheckpointManager._write = slow
state, cfg = small_state(0)
take_steps(state, cfg, 1)
ckpt_lib.save(ckpt_lib.make_manager(sys.argv[1]), state)
print("queued")
'''


def test_interpreter_exit_waits_for_the_write(tmp_path):
    tests = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [sys.executable, "-c", EXIT_SCRIPT, d,
             os.path.dirname(tests), tests],
            capture_output=True, text=True, timeout=240,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0 and "queued" in proc.stdout, \
            proc.stderr[-3000:]
        assert os.listdir(d) == ["1"]
        assert ckpt_lib.make_manager(d).all_steps() == [1]
