"""Checkpoints of the port: its own save/restore of a ``TrainState``,
keep-best retention, and the TF-slim checkpoint converter (slim
``resnet_v1_101/...`` variable names -> Flax-layout trees) for ImageNet
init.  Port of the JAX package's ``checkpoint.py``.

The JAX package writes Orbax, which the card's machine does not have; the
port writes its own format under the same directory layout and reads
both:

    <workdir>/checkpoints/<step>/state.pt       the rolling window
    <workdir>/checkpoints_best/<step>/state.pt  the keep-best slot
    <workdir>/checkpoints_best/best.json        {step, metric, value}

``state.pt`` is one ``torch.save`` of plain tensors, ints and dicts, which
``torch.load(..., weights_only=True)`` reads: ``step``, ``model`` (the
model's state dict: parameters and BN running statistics), ``optimizer``
(the optimizer's state dict: momentum buffers or AdamW's moments) and,
when the run keeps one, ``ema_params`` (the parameter EMA by name).  A
save writes ``<step>.tmp/`` and renames it into place, so a step
directory is either whole or absent.

A step directory the JAX package wrote (an Orbax step) is read by
``orbax_checkpoint.py`` into the same payload, its optimizer state by
parameter name (``TrainState.load_payload`` places it); one without its
``_CHECKPOINT_METADATA`` (not committed) is not a step, nor is Orbax's
``<step>.orbax-checkpoint-tmp-*``.  A directory may hold steps of both
formats (a run of the JAX package resumed by the port): they are listed,
restored and pruned alike.

Saves are asynchronous, as the JAX package's Orbax saves are
(``enable_async_checkpointing``): ``CheckpointManager.save`` copies the
payload into host buffers that the manager keeps from save to save
(pinned memory, with copies queued on the current CUDA stream, so that
the next step's in-place updates, queued after them, cannot overtake
them), and one background thread writes, syncs, renames and prunes.
Everything that reads or saves a directory waits first for the save in
flight there from this process (``save``, ``all_steps``, ``load`` and
so ``restore`` and ``restore_for_eval``, ``wait_until_finished``), and
so does interpreter exit; an error of the background write is raised by
the first of them.

Slim checkpoints are read by the port's own reader of TF's V1 and V2
formats (``tf_checkpoint.py``), in place of ``tf.train.load_checkpoint``,
and written (``export_slim_checkpoint``) by its writer of V2 bundles.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import logging
import os
import pathlib
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

import attentionalpoolingaction_torch.orbax_checkpoint as orbax_checkpoint
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import tf_checkpoint
from attentionalpoolingaction_torch.parallel import multihost

log = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"
_TMP_SUFFIX = ".tmp"


# ---------------------------------------------------------------------------
# save/restore
# ---------------------------------------------------------------------------

def _fsync_dir(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Write:
    """One background save: waits for its host copies, writes the step."""

    def __init__(self, manager, step: int, payload: dict, events: list):
        self.step = step
        self.error: BaseException | None = None
        self.thread = threading.Thread(
            target=self._run, args=(manager, payload, events),
            name=f"checkpoint-save-{step}")

    def _run(self, manager, payload, events):
        try:
            for event in events:
                event.synchronize()
            manager._write(self.step, payload)
        except BaseException as exc:     # raised again by _finish_write
            self.error = exc


# the save in flight from this process, by directory: every manager of a
# directory (a reader made after a save included) waits for it
_writes: dict[str, _Write] = {}
_writes_lock = threading.Lock()


def _finish_write(directory: pathlib.Path) -> None:
    """Wait for the save in flight to ``directory``, if any, and raise its
    error."""
    with _writes_lock:
        write = _writes.pop(str(directory.resolve()), None)
    if write is None:
        return
    write.thread.join()
    if write.error is not None:
        raise write.error


def _finish_all_writes() -> None:
    """At interpreter exit (after the write threads, which are not
    daemons, have ended): raise the error of a save nobody waited for."""
    with _writes_lock:
        dirs = list(_writes)
    for d in dirs:
        _finish_write(pathlib.Path(d))


atexit.register(_finish_all_writes)


def _map_tensors(tree, fn, path=()):
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return tree


class CheckpointManager:
    """Numbered step directories under ``directory``, the ``max_to_keep``
    newest kept (all when None).  Saves are atomic and asynchronous: see
    the module docstring."""

    def __init__(self, directory, max_to_keep: int | None = 3):
        self.directory = pathlib.Path(directory)
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)
        # host copies of the last payload saved, by path in the payload:
        # allocated once (pinned for CUDA tensors) and reused
        self._host: dict[tuple, torch.Tensor] = {}

    def _listed_steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir() and (
                          (p / orbax_checkpoint.COMMIT_FILE).exists()
                          or not orbax_checkpoint.is_orbax_step(p)))

    def all_steps(self) -> list[int]:
        """The committed steps, ascending, once the save in flight has
        committed; leftover ``<step>.tmp`` directories of an interrupted
        save, and Orbax steps that were not committed, are not steps."""
        _finish_write(self.directory)
        return self._listed_steps()

    def retained_steps(self, step: int) -> list[int]:
        """The steps the directory will hold once the save of ``step``
        (in flight or done) commits and the window is pruned, without
        waiting for it."""
        steps = sorted(set(self._listed_steps()) | {int(step)})
        return steps[-self.max_to_keep:] if self.max_to_keep else steps

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> pathlib.Path:
        return self.directory / str(int(step))

    def save(self, step: int, payload: dict) -> None:
        """Save ``payload`` as step ``step`` in the background, after the
        save in flight: its tensors are copied into the manager's host
        buffers here (on the CPU, before this returns; from a card, queued
        on the current stream), then a thread writes ``<step>.tmp/``,
        syncs it, renames it into place and prunes to ``max_to_keep``.  A
        step that is already saved raises, as Orbax's manager refuses
        it."""
        _finish_write(self.directory)
        step = int(step)
        if self.step_dir(step).exists():
            raise ValueError(f"step {step} is already saved under "
                             f"{self.directory}")
        host, events = self._stage(payload)
        write = _Write(self, step, host, events)
        with _writes_lock:
            _writes[str(self.directory.resolve())] = write
        write.thread.start()

    def _stage(self, payload: dict) -> tuple[dict, list]:
        """``payload`` with each tensor copied into its host buffer, and
        an event on each card's current stream after its copies."""
        used = {}
        devices = set()

        def copy(path, t):
            buf = self._host.get(path)
            if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                    or buf.stride() != t.stride()):
                buf = torch.empty_like(t, device="cpu",
                                       pin_memory=t.is_cuda)
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            if t.is_cuda:
                devices.add(t.device)
            used[path] = buf
            return buf

        host = _map_tensors(payload, copy)
        self._host = used
        events = []
        for device in devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append(event)
        return host, events

    def _write(self, step: int, payload: dict) -> None:
        """The background half of :meth:`save`."""
        final = self.step_dir(step)
        tmp = self.directory / f"{int(step)}{_TMP_SUFFIX}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with open(tmp / CHECKPOINT_FILE, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        if self.max_to_keep is not None:
            for s in self._listed_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    def load(self, step: int, map_location, *, mmap: bool = False,
             optimizer: bool = True) -> dict:
        """The payload of step ``step``, its tensors on ``map_location``
        (memory-mapped, and read only where touched, with ``mmap``), once
        the save in flight has committed.  An Orbax step is read by
        ``orbax_checkpoint.read_payload``, its optimizer state only with
        ``optimizer``."""
        _finish_write(self.directory)
        d = self.step_dir(step)
        f = d / CHECKPOINT_FILE
        if f.is_file():
            return torch.load(f, map_location=map_location,
                              weights_only=True, mmap=mmap)
        if orbax_checkpoint.is_orbax_step(d):
            payload = orbax_checkpoint.read_payload(d, optimizer=optimizer)
            return _map_tensors(payload,
                                lambda _, t: t.to(map_location))
        raise ValueError(f"{d} holds neither {CHECKPOINT_FILE} nor an Orbax "
                         "step: not a checkpoint of the port or of the JAX "
                         "package")

    def reload(self) -> None:
        """Nothing to drop: every listing reads the directory (kept for
        ``serving.CheckpointFollower``, as Orbax's manager has it)."""

    def wait_until_finished(self) -> None:
        """Wait for the save in flight and raise its error; then, in a job
        of several processes, meet every process at a barrier, so that
        each sees the step process 0 wrote.  Every process calls it."""
        _finish_write(self.directory)
        multihost.barrier()


def make_manager(workdir, max_to_keep: int | None = 3) -> CheckpointManager:
    return CheckpointManager(workdir, max_to_keep=max_to_keep)


def save(manager: CheckpointManager, state, step: int | None = None) -> None:
    """Save a ``train.TrainState`` as step ``step`` (default its own), in
    the background (:meth:`CheckpointManager.save`).  In a job of several
    processes every process calls it: the state is gathered whole (the
    head's class shards, ZeRO-1's slices) and process 0 queues the write;
    :meth:`CheckpointManager.wait_until_finished`, which every process
    calls, waits for it and meets the others."""
    payload = state.payload()
    if multihost.process_index() == 0:
        manager.save(int(state.step) if step is None else int(step),
                     payload)


def restore(manager: CheckpointManager, state, step: int | None = None):
    """Load step ``step`` (default the latest) into the live ``state`` in
    place, its tensors mapped to the model's device, whatever device or
    topology the step was saved from; every process of a job restores.  A
    saved EMA is read only into a state that keeps one; a state that
    keeps one raises on a step without it.  Returns the state, or None
    when there is no step."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return None
    device = next(state.model.parameters()).device
    payload = manager.load(step, map_location=device)
    if state.ema_params is not None and "ema_params" not in payload:
        raise ValueError(f"step {step} under {manager.directory} has no "
                         "ema_params to restore into the state's EMA")
    state.load_payload(payload)
    return state


def saved_tree_keys(manager: CheckpointManager, step=None) -> set:
    """Top-level keys of a saved step's payload (e.g. whether it carries
    ``ema_params``); an Orbax step's from its metadata alone."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return set()
    d = manager.step_dir(step)
    if not (d / CHECKPOINT_FILE).is_file() and \
            orbax_checkpoint.is_orbax_step(d):
        return orbax_checkpoint.payload_keys(d)
    return set(manager.load(step, map_location="cpu", mmap=True))


@dataclasses.dataclass
class EvalState:
    """What inference needs from a step, in the Flax layout of numpy
    arrays that ``serving.Predictor`` and ``evaluate`` take."""
    step: int
    params: Any
    batch_stats: Any
    # present iff the run trained with config.ema_decay
    ema_params: Any = None


def restore_for_eval(manager: CheckpointManager, step=None
                     ) -> EvalState | None:
    """Restore only what inference needs (step, params, batch_stats and
    the EMA when saved), on the CPU whatever device saved it, and ignore
    the optimizer state (so a change of optimizer between the run and the
    eval does not matter)."""
    step = manager.latest_step() if step is None else step
    if step is None:
        return None
    payload = manager.load(step, map_location="cpu", mmap=True,
                           optimizer=False)
    params, batch_stats = convert.state_dict_to_flax(payload["model"])
    ema = payload.get("ema_params")
    return EvalState(
        step=int(payload["step"]), params=params, batch_stats=batch_stats,
        ema_params=None if ema is None else convert.state_dict_to_flax(ema)[0])


# ---------------------------------------------------------------------------
# Keep-best retention
# ---------------------------------------------------------------------------

BEST_SUBDIR = "checkpoints_best"


def best_metric_of(results: dict) -> tuple[str, float]:
    """The metric that ranks checkpoints for a dataset's eval protocol:
    mAP (MPII/HICO) with accuracy as the fallback (HMDB)."""
    for k in ("mAP", "accuracy"):
        if k in results and results[k] == results[k]:  # present, not NaN
            return k, float(results[k])
    raise ValueError(f"no rankable metric in {sorted(results)}")


class BestKeeper:
    """Keep the argmax-metric checkpoint beside the rolling window.

    The main manager keeps the ``max_to_keep`` NEWEST steps, so a long
    fine-tune that peaks mid-run would prune its best checkpoint.  The
    keeper holds a single-slot manager under ``<workdir>/checkpoints_best``
    and a ``best.json`` ({step, metric, value}) saying what it holds; eval
    hooks call :meth:`update` with each eval's results and the live
    ``TrainState``, and only a strict improvement saves.  The whole state
    is saved (EMA included); ``best.json`` persists, so a restarted run
    keeps ranking against the best from before the restart.
    """

    def __init__(self, workdir):
        self.dir = pathlib.Path(workdir) / BEST_SUBDIR
        self._mgr = CheckpointManager(self.dir, max_to_keep=1)
        self._meta = self.dir / "best.json"

    def best(self) -> dict | None:
        """The committed best record, or None.  A meta file whose step the
        slot does not hold (a crash between a save and its meta, or the
        slot deleted by hand) is stale: it reads as None, so the next
        eval's save fills the slot again instead of being blocked by it."""
        if not self._meta.exists():
            return None
        meta = json.loads(self._meta.read_text())
        if int(meta.get("step", -1)) not in self._mgr.all_steps():
            log.warning(
                "best.json points at step %s but %s holds %s — stale "
                "(crash before the save committed?); ignoring it",
                meta.get("step"), self.dir, self._mgr.all_steps())
            return None
        return meta

    def update(self, step: int, results: dict, state) -> bool:
        """Save ``state`` iff ``results`` beats the stored best; returns
        whether it saved.  The save commits first (this waits for it, as
        the JAX package does) and the meta is written after it, so a crash
        in between leaves at worst a checkpoint without a meta, never a
        meta naming an uncommitted checkpoint."""
        name, value = best_metric_of(results)
        prev = self.best()
        if prev is not None and value <= float(prev["value"]):
            return False
        save(self._mgr, state, step=int(step))
        self._mgr.wait_until_finished()
        if multihost.process_index() != 0:
            return True
        tmp = self._meta.with_name(self._meta.name + _TMP_SUFFIX)
        tmp.write_text(json.dumps(
            {"step": int(step), "metric": name, "value": value}))
        os.replace(tmp, self._meta)
        log.info("new best %s=%.6f at step %d -> %s", name, value,
                 int(step), self.dir)
        return True

    def wait_until_finished(self):
        self._mgr.wait_until_finished()


def manager_for_step(workdir, step):
    """Resolve a ``--step`` value to ``(manager, concrete_step)``: None
    (the latest), an int or numeric string (that step of the rolling
    window), or ``"best"`` (the keep-best slot, whose one step is the
    best, so the latest there resolves it)."""
    if isinstance(step, str) and step.strip().lower() == "best":
        return make_manager(pathlib.Path(workdir) / BEST_SUBDIR), None
    if isinstance(step, str):
        step = int(step)
    return make_manager(pathlib.Path(workdir) / "checkpoints"), step


# ---------------------------------------------------------------------------
# TF-slim checkpoint conversion
# ---------------------------------------------------------------------------

_SLIM_BN = {"gamma": "scale", "beta": "bias",
            "moving_mean": "mean", "moving_variance": "var"}


def _map_slim_name(name: str, model_scope: str):
    """Map one slim variable name to (collection, flax_path_tuple).

    Slim layout:
      resnet_v1_101/conv1/weights                         (7,7,3,64)
      resnet_v1_101/conv1/BatchNorm/{gamma,beta,moving_*}
      resnet_v1_101/block1/unit_1/bottleneck_v1/conv1/weights
      resnet_v1_101/block1/unit_1/bottleneck_v1/shortcut/weights
      resnet_v1_101/logits/{weights,biases}
    Flax layout (note "block1/unit_1" is a SINGLE module name, one key):
      params:      resnet / conv1 / kernel
                   resnet / conv1_bn / {scale,bias}
                   resnet / "block1/unit_1" / {conv1,conv1_bn,shortcut,...}
      batch_stats: resnet / conv1_bn / {mean,var}
    """
    name = name.removeprefix(model_scope + "/")
    parts = [p for p in name.split("/") if p != "bottleneck_v1"]
    # merge blockX/unit_Y into the single Flax module key "blockX/unit_Y"
    if len(parts) >= 2 and parts[0].startswith("block"):
        parts = [parts[0] + "/" + parts[1]] + parts[2:]
    # only backbone scopes map onto the model; the ImageNet classifier
    # (resnet_v1_101/logits/{weights,biases}) and anything else unknown
    # are skipped by the caller
    if not (parts[0] == "conv1" or re.fullmatch(r"block\d+/unit_\d+",
                                                parts[0])):
        return None
    leaf = parts[-1]
    if leaf in ("weights", "biases"):
        flax_leaf = "kernel" if leaf == "weights" else "bias"
        return "params", tuple(["resnet"] + parts[:-1] + [flax_leaf])
    if len(parts) >= 3 and parts[-2] == "BatchNorm" and leaf in _SLIM_BN:
        conv_name = parts[-3]
        coll = "batch_stats" if leaf.startswith("moving_") else "params"
        path = parts[:-3] + [conv_name + "_bn", _SLIM_BN[leaf]]
        return coll, tuple(["resnet"] + path)
    return None


_SLIM_BN_INV = {"scale": "gamma", "bias": "beta",
                "mean": "moving_mean", "var": "moving_variance"}


def _map_flax_path(coll: str, path: tuple, model_scope: str):
    """Inverse of _map_slim_name: Flax (collection, path) -> slim var name.
    Returns None for paths outside the backbone (heads etc.)."""
    if not path or path[0] != "resnet":
        return None
    parts = list(path[1:])
    # split merged "blockX/unit_Y" keys back into two scopes + bottleneck_v1
    if parts and "/" in parts[0]:
        block, unit = parts[0].split("/", 1)
        parts = [block, unit, "bottleneck_v1"] + parts[1:]
    leaf = parts[-1]
    if parts[-2].endswith("_bn"):
        conv = parts[-2][: -len("_bn")]
        return "/".join([model_scope] + parts[:-2]
                        + [conv, "BatchNorm", _SLIM_BN_INV[leaf]])
    if leaf == "kernel":
        return "/".join([model_scope] + parts[:-1] + ["weights"])
    if leaf == "bias":
        return "/".join([model_scope] + parts[:-1] + ["biases"])
    return None


def convert_slim_checkpoint(ckpt_path: str, *,
                            model_scope: str = "resnet_v1_101"):
    """Read a TF1-slim ResNet checkpoint (V2 prefix or V1 file) and return
    {"params": ..., "batch_stats": ...} nested dicts of numpy arrays in the
    Flax layout (under a top-level "resnet" module), skipping optimizer
    slots, ``global_step`` and the variables outside the backbone.  Slim
    conv kernels are HWIO like Flax's, so nothing is transposed."""
    reader = tf_checkpoint.CheckpointReader(ckpt_path)
    shapes = reader.get_variable_to_shape_map()
    out: dict[str, Any] = {"params": {}, "batch_stats": {}}
    skipped = []
    for var_name in sorted(shapes):
        clean = var_name.split(":")[0]
        if any(s in clean for s in (
                "Momentum", "global_step", "ExponentialMovingAverage",
                "RMSProp", "Adam", "beta1_power", "beta2_power")):
            continue
        mapped = _map_slim_name(clean, model_scope)
        if mapped is None:
            skipped.append(clean)
            continue
        coll, path = mapped
        value = np.asarray(reader.get_tensor(clean))
        node = out[coll]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    if skipped:
        log.info("slim convert: skipped %d vars (e.g. %s)",
                 len(skipped), skipped[:3])
    return out


def export_slim_checkpoint(variables, path: str, *,
                           model_scope: str = "resnet_v1_101") -> int:
    """Write the backbone of the Flax-layout ``variables`` (``params`` and
    ``batch_stats``) as the TF-slim V2 checkpoint ``path``, under slim's
    names (the inverse of :func:`convert_slim_checkpoint`), with the
    port's writer (``tf_checkpoint.write_v2``).  Returns the number of
    variables written."""
    named = {}
    for coll in ("params", "batch_stats"):
        for fpath, val in _flatten(variables.get(coll, {})).items():
            name = _map_flax_path(coll, fpath, model_scope)
            if name is not None:
                named[name] = np.asarray(val)
    return tf_checkpoint.write_v2(path, named)


def _copy_tree(tree):
    """New dicts all the way down, the same leaves."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def merge_pretrained(variables, converted, *, exclude: tuple[str, ...] = ()):
    """Overlay converted slim weights onto freshly initialized variables,
    leaving new-head scopes untouched (the reference's exclusion-list
    fine-tune init).

    ``exclude``: regexes matched against the slash-joined relative path
    (e.g. ``("head", "pose_head")``).  Raises on any shape mismatch or on
    converted vars missing from the model.
    """
    flat_conv = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(converted.get(coll, {})).items():
            flat_conv[(coll,) + path] = val

    out = _copy_tree(variables)
    applied = 0
    for (coll, *path), val in flat_conv.items():
        if coll not in variables:
            continue
        rel = "/".join(path)
        if any(re.match(e, rel) for e in exclude):
            continue
        node = out[coll]
        try:
            for key in path[:-1]:
                node = node[key]
            cur = node[path[-1]]
        except KeyError:
            raise KeyError(f"converted var {coll}/{rel} not in model")
        val = np.asarray(val)
        if tuple(cur.shape) != tuple(val.shape):
            raise ValueError(
                f"shape mismatch at {coll}/{rel}: model {cur.shape} "
                f"vs checkpoint {val.shape}")
        node[path[-1]] = val.astype(np.asarray(cur).dtype)
        applied += 1
    log.info("merged %d pretrained vars", applied)
    return out


def _flatten(tree, prefix=()):
    """Flatten a nested dict to {path_tuple: leaf} (keys may contain '/')."""
    flat = {}
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            flat.update(_flatten(v, p))
        else:
            flat[p] = v
    return flat
