"""Evaluation driver: run a split through the model, accumulate (logits,
labels), compute mAP (MPII/HICO) or per-video accuracy (HMDB51).  Port of
the JAX package's ``evaluate.py`` on one device.

The forward runs on the device (on a card, the pooling head's hand-written
kernels launch once a batch); the metrics are NumPy on the host
(``ops/metrics.py``).  Evaluation never touches the state it is given: the
weights are loaded into a model of its own (the ``Evaluator``'s, built
once), so evaluating the live training model leaves its parameters, BN
statistics and train mode as they were, and ``eval_ema`` does not write the
EMA into the training parameters.

Without an ``eval_iter`` the split of ``cfg.eval_pattern`` is read through
the port's input pipeline (:func:`make_eval_input`), decoded on the
device.

Clip eval (``clip_frames`` > 1) reads ``eval_clips`` x ``eval_multicrop``
clip rows a video, which the per-video averaging of :func:`compute_metrics`
combines.  ``eval_int8`` evaluates the BN-folded int8 forward
(:func:`make_int8_eval_step`, ``models/inference.py``).

In a job of several processes (``parallel.multihost.setup``, one card a
process) each process reads its shard of the split, unless the caller
hands it an iterator, and the logits, labels, masks, annotations and
video ids are gathered (``multihost.allgather_host_arrays``, padded to
the largest shard), so that every process computes the same metrics as
one process would.
"""

from __future__ import annotations

import logging
from typing import Iterable

import numpy as np
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch.convert import load_flax_variables
from attentionalpoolingaction_torch.data import grain_pipeline
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models import inference as inf
from attentionalpoolingaction_torch.ops import metrics as metrics_lib
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.train import (
    TrainState,
    batch_to_device,
    build_model,
    normalize_images,
)

__all__ = ["Evaluator", "compute_metrics", "eval_logits", "evaluate",
           "make_eval_input", "make_eval_step", "make_int8_eval_step",
           "make_multicrop_eval_step", "mesh_from_config"]

log = logging.getLogger(__name__)


def mesh_from_config(cfg: config_lib.TrainConfig):
    """None: the eval forward runs on this process's one card.  The JAX
    function builds a mesh of the local devices only (a process fetches
    its logits to the host), and returns None where a process has one
    device; the port has one card a process, so what is sharded is the
    split (:func:`make_eval_input`), by process."""
    del cfg
    return None


def make_eval_step(model: torch.nn.Module):
    """``step_fn(images) -> logits``: the model's eval-mode forward of a
    (B, H, W, 3) batch (or (B, T, H, W, 3) clips) on its device."""
    @torch.inference_mode()
    def step_fn(images):
        return model(normalize_images(images))["logits"]

    return step_fn


def make_multicrop_eval_step(model: torch.nn.Module):
    """``step_fn(images) -> logits``: forward (B, crops, H, W, 3) as one
    batch of B * crops and average the logits over the crops."""
    @torch.inference_mode()
    def step_fn(images):
        b, c = images.shape[:2]
        flat = images.reshape((b * c,) + tuple(images.shape[2:]))
        logits = model(normalize_images(flat))["logits"]
        return logits.reshape(b, c, -1).mean(dim=1)

    return step_fn


def make_int8_eval_step(cfg: config_lib.TrainConfig, mesh=None,
                        multicrop: bool = False, *, device=None):
    """``step_fn(params, batch_stats, images) -> logits`` over the
    quantized serving path (``models/inference.py``) on ``device``
    (default ``cuda``): BN-folded backbone, per-channel int8 weights,
    per-example activation scales, activations in bfloat16 with
    ``bf16_backbone``, else float32.  ``params`` and ``batch_stats`` are
    Flax-layout arrays; they are folded and quantized again only when
    ``params`` is another object than the last call's (a strong
    reference, so a recycled ``id()`` cannot serve stale weights).  With
    ``multicrop`` the images are (B, crops, H, W, 3) and the logits are
    averaged over the crops.  ``mesh`` is :func:`mesh_from_config`'s: the
    step is this process's, on its split's shard."""
    del mesh
    device = resolve_device(device)
    pooling = "avg" if cfg.pooling == "avg" else "attention"
    dtype = torch.bfloat16 if cfg.bf16_backbone else torch.float32
    cache: dict = {}

    @torch.inference_mode()
    def step_fn(params, batch_stats, images):
        if cache.get("params") is not params:       # a new checkpoint
            folded = inf.fold_backbone(
                {"params": params, "batch_stats": batch_stats},
                cfg.backbone, device=device)
            cache.update(params=params, q=inf.quantize_folded(folded),
                         head=inf.head_weights(params, device)["head"])
        if multicrop:
            b, c = images.shape[:2]
            images = images.reshape((b * c,) + tuple(images.shape[2:]))
        logits = inf.folded_forward(
            cache["q"], cache["head"], normalize_images(images),
            backbone=cfg.backbone, pooling=pooling, dtype=dtype)["logits"]
        if multicrop:
            logits = logits.reshape(b, c, -1).mean(dim=1)
        return logits

    return step_fn


def make_eval_input(cfg: config_lib.TrainConfig, spec,
                    shard_by_process: bool = False, *, device=None):
    """One pass over ``cfg.eval_pattern`` in file order, decoded and cropped
    on ``device`` (default ``cuda``): central crops (uint8 with
    ``transfer_uint8``), or ``eval_multicrop`` crops an example, in
    batches of ``eval_batch_size`` with the last padded (``mask`` 0).
    ``input_pipeline`` "tfdata" and "grain" both read through the port's
    pipeline.  With ``clip_frames`` > 1 (``input_pipeline`` "grain" only,
    as in the JAX package): ``eval_clips`` deterministic float32 clips a
    video, each in ``eval_multicrop`` crops folded into rows.  With
    ``shard_by_process`` in a job of several processes, this process's
    shard of the rows (every ``process_count``-th from its index)."""
    if cfg.eval_clips > 1 and cfg.clip_frames <= 1:
        raise ValueError(
            f"eval_clips={cfg.eval_clips} requires clip mode "
            "(clip_frames > 1) — per-frame eval would silently ignore it")
    if cfg.clip_frames > 1 and cfg.input_pipeline != "grain":
        raise ValueError(
            "clip_frames > 1 eval requires input_pipeline='grain' "
            "(the clip sampler runs on the random-access video index)")
    if not cfg.eval_pattern:
        raise ValueError("no eval_iter and no cfg.eval_pattern")
    kw = dict(batch_size=cfg.eval_batch_size, image_size=cfg.image_size,
              resize_min=cfg.resize_min_resolved, device=device)
    if shard_by_process:
        kw.update(shard_index=multihost.process_index(),
                  shard_count=multihost.process_count())
    if cfg.clip_frames > 1:
        return grain_pipeline.make_video_clip_eval_dataset(
            cfg.eval_pattern, spec, clip_frames=cfg.clip_frames,
            num_clips=cfg.eval_clips,
            num_crops=(cfg.eval_multicrop if cfg.eval_multicrop
                       and cfg.eval_multicrop > 1 else 1), **kw)
    if _multicrop(cfg):
        return grain_pipeline.make_multicrop_eval_dataset(
            cfg.eval_pattern, spec, num_crops=cfg.eval_multicrop, **kw)
    return grain_pipeline.make_eval_dataset(
        cfg.eval_pattern, spec, transfer_uint8=cfg.transfer_uint8, **kw)


def _multicrop(cfg: config_lib.TrainConfig) -> bool:
    # clip mode folds crops into ROWS, so the (B, crops, H, W, 3) step
    # applies to the image path only
    return bool(cfg.eval_multicrop and cfg.eval_multicrop > 1
                and cfg.clip_frames <= 1)


def _weights(state, use_ema: bool):
    """The weights of ``state`` to evaluate: a ``TrainState``'s state dict
    (its parameters replaced by its EMA with ``use_ema``), or the
    Flax-layout ``(params or ema_params, batch_stats)`` arrays of
    ``checkpoint.restore_for_eval``."""
    ema = getattr(state, "ema_params", None)
    if use_ema and ema is None:
        raise ValueError(
            "eval_ema=True but the state/checkpoint has no ema_params "
            "— train with --set ema_decay=0.9999 (or similar) first")
    if isinstance(state, TrainState):
        sd = state.full_state_dict()
        if use_ema:
            sd.update(state.full_ema())
        return sd
    return (ema if use_ema else state.params), state.batch_stats


def _start_fetch(logits: torch.Tensor):
    """Start the copy of ``logits`` (as float32) to the host: on a card,
    into pinned memory behind the forward on the same stream, with an
    event recorded after it.  Returns ``(host tensor, event or None)``;
    the host tensor is ready once the event has completed."""
    logits = logits.to(torch.float32)
    if logits.device.type != "cuda":
        return logits, None
    host = torch.empty(logits.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(logits, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def eval_logits(step_fn, eval_iter: Iterable, *, device,
                max_batches: int | None = None) -> dict[str, np.ndarray]:
    """Run ``eval_iter``'s numpy batches through ``step_fn`` and return
    the host arrays: ``logits``, ``label``, ``mask`` and, where the
    batches have them, ``anno`` and ``video_id`` (padding rows included).

    Pipelined one deep: batch N's forward and the copy of its logits to
    pinned host memory are queued, then batch N+1's forward, and only then
    does the host wait, on an event recorded after N's copy.  So the host
    reads N while the device computes N+1, and prepares and queues N+2
    meanwhile; the results are the same bits as a fetch after each batch,
    only the order of waiting moves."""
    device = torch.device(device)
    host: dict[str, list] = {"logits": [], "label": [], "mask": [],
                             "anno": [], "video_id": []}

    def collect(fetch, batch):
        logits, event = fetch
        if event is not None:
            event.synchronize()
        host["logits"].append(logits.numpy())
        for k in ("label", "mask", "anno", "video_id"):
            if k in batch:
                host[k].append(np.asarray(batch[k]))

    pending = None
    for i, batch in enumerate(eval_iter):
        if max_batches is not None and i >= max_batches:
            break
        images = batch_to_device({"image": batch["image"]}, device)["image"]
        fetch = _start_fetch(step_fn(images))
        if pending is not None:
            collect(*pending)
        pending = (fetch, batch)
    if pending is not None:
        collect(*pending)
    return {k: np.concatenate(v) for k, v in host.items() if v}


def _gather_keys(host: dict, spec) -> dict:
    """``host`` with every key the gather pairs, an empty shard's too: a
    process with no rows still joins the collective with (0, ...) arrays
    of the same dtypes."""
    c = spec.num_classes
    empty = {"logits": np.zeros((0, c), np.float32),
             "label": (np.zeros((0, c), np.float32) if spec.multi_label
                       else np.zeros((0,), np.int32)),
             "mask": np.zeros((0,), np.float32)}
    if spec.multi_label:
        empty["anno"] = np.zeros((0, c), np.int32)
    if spec.is_video:
        empty["video_id"] = np.zeros((0,), np.int32)
    out = {k: host.get(k, v) for k, v in empty.items()}
    return {k: np.asarray(v, empty[k].dtype) for k, v in out.items()}


def compute_metrics(cfg: config_lib.TrainConfig, host: dict, *,
                    return_per_class: bool = False) -> dict:
    """The dataset's eval protocol on :func:`eval_logits`'s arrays; rows
    whose ``mask`` is 0 (the padding of a last batch) drop out first."""
    spec = get_dataset(cfg.dataset)
    c = spec.num_classes
    mask = (host["mask"].astype(bool) if "mask" in host
            else np.zeros(0, bool))
    logits = host.get("logits", np.zeros((0, c), np.float32))[mask]
    labels = host.get("label", np.zeros((0,), np.int32))[mask]

    results = {"num_examples": int(mask.sum())}
    if spec.eval_metric == "map":
        if not spec.multi_label:
            onehot = np.zeros_like(logits)
            onehot[np.arange(labels.size), labels] = 1.0
            labels_mh = onehot
        else:
            labels_mh = labels
        m, aps = metrics_lib.mean_average_precision(labels_mh, logits)
        results["mAP"] = m
        results["num_eval_classes"] = int(np.sum(~np.isnan(aps)))
        if return_per_class:
            results["per_class_ap"] = [
                None if np.isnan(a) else float(a) for a in aps]
        if not spec.multi_label:
            results["accuracy"] = metrics_lib.accuracy(labels, logits)
        if "anno" in host:
            # HICO "Known Object" protocol: per class, drop unknown pairs
            # instead of counting them as negatives.  Records without the
            # anno field parse as all-zero -> nothing known -> skip.
            anno = host["anno"][mask]
            if np.any(anno != 0):
                ko, ko_aps = metrics_lib.mean_average_precision_known(
                    anno, logits)
                results["mAP_ko"] = ko
                if return_per_class:
                    results["per_class_ap_ko"] = [
                        None if np.isnan(a) else float(a) for a in ko_aps]
    else:  # HMDB51: per-video temporal averaging then accuracy
        vids = host["video_id"][mask]
        _, avg, vid_labels = metrics_lib.video_average_logits(
            vids, logits, labels)
        results["accuracy"] = metrics_lib.accuracy(vid_labels, avg)
        if cfg.clip_frames > 1:
            # each row is a CLIP VIEW (clip x crop, already video-level),
            # not a frame; the row-level number is only informative with
            # several views per video (accuracy before averaging)
            if cfg.eval_clips > 1 or (cfg.eval_multicrop
                                      and cfg.eval_multicrop > 1):
                results["per_clip_accuracy"] = metrics_lib.accuracy(
                    labels, logits)
        else:
            results["per_frame_accuracy"] = metrics_lib.accuracy(
                labels, logits)
        results["num_videos"] = int(avg.shape[0])
    log.info("eval %s: %s", cfg.dataset, results)
    return results


def _state_device(state, device):
    if device is None and isinstance(state, TrainState):
        return next(state.model.parameters()).device
    return resolve_device(device)


def evaluate(cfg: config_lib.TrainConfig, state, *, eval_iter=None,
             max_batches=None, return_per_class=False, device=None):
    """The metrics dict of the configured dataset's protocol for the
    weights of ``state`` (a ``TrainState``, or ``restore_for_eval``'s
    Flax-layout arrays), their EMA with ``cfg.eval_ema``, over
    ``eval_iter``, an iterator of numpy batches (``image``, ``label``,
    ``mask``; ``anno`` for HICO, ``video_id`` for HMDB), or by default
    the records of ``cfg.eval_pattern`` (:func:`make_eval_input`).  Runs on
    ``device``: default the state's own, or ``cuda`` for arrays.
    ``return_per_class`` adds the per-class AP vector.  Builds a model
    for the call; :class:`Evaluator` builds one for many."""
    return Evaluator(cfg, device=_state_device(state, device))(
        state, eval_iter=eval_iter, max_batches=max_batches,
        return_per_class=return_per_class)


class Evaluator:
    """Reusable evaluator: builds the model and its eval step once, on
    ``device`` (default ``cuda``); each call loads the weights of the state
    it is given into that model and evaluates a fresh pass of its
    iterator.  With ``eval_int8`` there is no model: each call folds and
    quantizes the state's weights for :func:`make_int8_eval_step`."""

    def __init__(self, cfg: config_lib.TrainConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.eval_int8:
            self.model = self.step_fn = None
            self.int8_step = make_int8_eval_step(
                cfg, multicrop=_multicrop(cfg), device=self.device)
            return
        self.model = build_model(cfg, device=self.device)
        self.step_fn = (make_multicrop_eval_step(self.model)
                        if _multicrop(cfg) else make_eval_step(self.model))

    def logits(self, state, eval_iter=None, *, max_batches=None
               ) -> dict[str, np.ndarray]:
        """:func:`eval_logits` of the weights of ``state`` (see
        :func:`evaluate`); in a job of several processes with no
        ``eval_iter``, every process's shard, gathered."""
        spec = get_dataset(self.cfg.dataset)
        shard = multihost.process_count() > 1 and eval_iter is None
        if eval_iter is None:
            eval_iter = make_eval_input(self.cfg, spec, shard_by_process=shard,
                                        device=self.device)
        weights = _weights(state, self.cfg.eval_ema)
        if self.cfg.eval_int8:
            params, batch_stats = (weights if isinstance(weights, tuple)
                                   else convert.state_dict_to_flax(weights))

            def step_fn(images):
                return self.int8_step(params, batch_stats, images)
        elif isinstance(weights, tuple):
            load_flax_variables(self.model, *weights)
            step_fn = self.step_fn
        else:
            self.model.load_state_dict(weights)
            step_fn = self.step_fn
        host = eval_logits(step_fn, eval_iter, device=self.device,
                           max_batches=max_batches)
        if shard:
            host = multihost.allgather_host_arrays(_gather_keys(host, spec))
        return host

    def __call__(self, state, *, eval_iter=None, max_batches=None,
                 return_per_class=False):
        host = self.logits(state, eval_iter, max_batches=max_batches)
        return compute_metrics(self.cfg, host,
                               return_per_class=return_per_class)
