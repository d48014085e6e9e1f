"""Training: losses, optimizer, train step and loop.  Port of the JAX
package's ``train.py`` on one device.

``create_state`` builds the model, its optimizer and the parameter EMA;
``make_train_step`` gives the step: forward in train mode (batch norm
moves its running statistics in place), the classification and pose
losses, backward, global-norm clip, weight decay and SGD with momentum
(or AdamW), then the EMA.  ``train`` runs the step over an iterator of
numpy batches.  On a CUDA device the attentional pooling head runs the
hand-written kernels in its forward (``ops/attn_pool_cuda.py``).

Where optax and torch differ, the port follows optax:

  * the clip scales by ``min(1, max_norm / |g|)`` (``clip_grad_norm_``
    adds 1e-6 to the norm);
  * the learning rate of a step is the schedule at the count of updates
    made before it;
  * torch SGD's momentum buffer (dampening 0) is optax's ``trace``.

``train`` resumes from, and saves to, a ``checkpoint.CheckpointManager``
and stops cleanly on SIGTERM; ``init_checkpoint`` starts a run from a
TF-slim checkpoint or warm-starts it from a run of the port.  Without an
iterator it reads ``cfg.train_pattern`` through the port's input pipeline
(``data/grain_pipeline.py``, JPEG decode on the device), whose position
is saved with each checkpoint; ``data_echo`` repeats each batch.

With ``bf16_backbone`` the backbone computes in bfloat16
(``models/resnet.py``); the parameters, the gradients, the optimizer, the
clip, the EMA, the losses and the logits stay float32.  A video dataset
trains on one fresh frame per video an epoch, or with ``clip_frames`` > 1
on TSN clips of (B, T, H, W, 3) (``data/grain_pipeline.py``).

Over a mesh (``parallel/mesh.py``: one process a card, joined by
``parallel.multihost.setup``), ``create_state(..., mesh=)`` and
``make_train_step(..., mesh)`` train data-parallel: each rank takes its
share of the batch's rows, each loss that divides by a count divides by
the global one (each rank's loss is its share of the global loss), the
gradients are all-reduced (summed) over the ``data`` axis as flat
buckets, batch norm's train-mode statistics are the global batch's, the
clip reads the reduced gradients, and every rank makes the same update.
With a ``model`` axis the head's classes shard over it
(``models/heads.py``); with ``zero1`` each rank keeps a slice of the
optimizer's state (``parallel/zero1.py``).  ``train`` builds a mesh only
when there is more than one process and ``mesh_shape`` asks for more than
one device, as the JAX package does; otherwise it trains alone.

With ``remat_units`` each bottleneck of the backbone is rematerialized
in the backward (``models/resnet.py``), its batch norms moving their
running statistics once a step.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import pathlib
import re
import signal
import threading
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch.convert import (
    load_flax_variables,
    state_dict_to_flax,
)
from attentionalpoolingaction_torch.data import grain_pipeline, pipeline
from attentionalpoolingaction_torch.data.datasets import (
    DatasetSpec,
    get_dataset,
)
from attentionalpoolingaction_torch.data.preprocessing import (
    B_MEAN,
    G_MEAN,
    R_MEAN,
)
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models.action_model import ActionModel
from attentionalpoolingaction_torch.models.factory import get_model
from attentionalpoolingaction_torch.models.resnet import (
    BatchNorm,
    feature_size,
)
from attentionalpoolingaction_torch.ops import heatmap as hm
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.parallel.zero1 import Zero1Optimizer

__all__ = [
    "TrainState", "apply_gradients", "batch_to_device", "build_model",
    "classification_loss", "create_state", "decay_mask", "feature_size",
    "make_learning_rate", "make_loss_fn", "make_optimizer",
    "make_train_step", "normalize_images", "pose_targets", "train",
]

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    step: int                     # updates made so far
    model: ActionModel
    optimizer: torch.optim.Optimizer
    # parameter EMA by parameter name (config.ema_decay, slim's
    # moving_average_decay); None when off
    ema_params: dict[str, torch.Tensor] | None = None
    # the mesh the state was made for, and its sharding plan (None alone)
    mesh: object = None
    plan: mesh_lib.ShardingPlan | None = None

    # -- the whole state, as one process holds it -------------------------
    # Under tensor parallelism the head's class shards are gathered over
    # the model axis (collectives: every rank calls these); ZeRO-1's
    # optimizer gathers its own slices.  A payload is the same on every
    # topology, so a checkpoint moves between them.

    def _sharded(self) -> dict[str, mesh_lib.LeafPlan]:
        if self.plan is None:
            return {}
        return {n: pl for n, pl in self.plan.params.items()
                if pl.kind == "model"}

    def _gather(self, tensors: dict, sharded: dict) -> dict:
        group = mesh_lib.axis_group(self.mesh, "model")
        return {n: (mesh_lib.all_gather_cat(t, sharded[n].dim, group)
                    if n in sharded else t) for n, t in tensors.items()}

    def _slice(self, tensors: Mapping, sharded: dict) -> dict:
        i = mesh_lib.axis_index(self.mesh, "model")
        m = mesh_lib.axis_size(self.mesh, "model")
        return {n: (mesh_lib.shard_slice(t, sharded[n], i, m)
                    if n in sharded else t) for n, t in tensors.items()}

    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with the head whole."""
        return self._gather(self.model.state_dict(), self._sharded())

    def full_ema(self) -> dict[str, torch.Tensor] | None:
        if self.ema_params is None:
            return None
        return self._gather(dict(self.ema_params), self._sharded())

    def payload(self) -> dict:
        """What a checkpoint holds: ``step``, ``model`` (the whole state
        dict), ``optimizer`` (the whole optimizer state dict) and, when
        the run keeps one, ``ema_params``."""
        sharded = self._sharded()
        opt = self.optimizer.state_dict()
        if sharded:
            names = optimizer_param_names(self.model)
            opt = {"param_groups": opt["param_groups"],
                   "state": {k: self._gather(buf, {
                       b: sharded[names[int(k)]] for b, v in buf.items()
                       if names[int(k)] in sharded and v.ndim})
                       for k, buf in opt["state"].items()}}
        out = {"step": int(self.step), "model": self.full_state_dict(),
               "optimizer": opt}
        if self.ema_params is not None:
            out["ema_params"] = self.full_ema()
        return out

    def _by_index(self, by_name: Mapping) -> dict:
        """An optimizer state dict of this state's optimizer from buffers
        by parameter name (an Orbax step's), with the live optimizer's
        hyperparameters (the config's)."""
        names = optimizer_param_names(self.model)
        if set(by_name) != set(names):
            raise KeyError(
                "the saved optimizer state does not cover the model's "
                f"parameters: missing {sorted(set(names) - set(by_name))[:5]}"
                f", unknown {sorted(set(by_name) - set(names))[:5]}")
        groups, start = [], 0
        for g in self.optimizer.param_groups:
            n = len(g["params"])
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + n))})
            start += n
        return {"state": {i: dict(by_name[n]) for i, n in enumerate(names)},
                "param_groups": groups}

    def load_payload(self, payload: Mapping) -> None:
        """Load a :meth:`payload`, in place, keeping this rank's shards.
        An optimizer state without ``param_groups`` is by parameter name
        (an Orbax step's)."""
        sharded = self._sharded()
        opt = payload["optimizer"]
        if "param_groups" not in opt:
            opt = self._by_index(opt["state"])
        self.model.load_state_dict(self._slice(payload["model"], sharded))
        if sharded:
            names = optimizer_param_names(self.model)
            opt = {"param_groups": opt["param_groups"],
                   "state": {k: self._slice(buf, {
                       b: sharded[names[int(k)]] for b, v in buf.items()
                       if names[int(k)] in sharded and v.ndim})
                       for k, buf in opt["state"].items()}}
        self.optimizer.load_state_dict(opt)
        if self.ema_params is not None:
            ema = self._slice(payload["ema_params"], sharded)
            with torch.no_grad():
                for name, t in self.ema_params.items():
                    t.copy_(ema[name])
        self.step = int(payload["step"])


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Device-side VGG mean subtraction for uint8 batches (4x less
    host-to-device traffic than f32); float inputs pass through (already
    normalized on the host)."""
    if images.dtype.is_floating_point:
        return images
    # a scalar a channel, not a mean tensor: a traced program (export.py)
    # then holds no constant bound to the device it was traced on.  The
    # float32 bits are those of subtracting a float32 mean vector.
    x = images.to(torch.float32)
    return torch.stack([x[..., 0] - R_MEAN, x[..., 1] - G_MEAN,
                        x[..., 2] - B_MEAN], dim=-1)


def build_model(cfg: config_lib.TrainConfig, device=None,
                generator: torch.Generator | None = None) -> ActionModel:
    """The config's ActionModel in eval mode on ``device`` (default
    ``cuda``), drawn from ``generator``.  The backbone computes in
    bfloat16 with ``bf16_backbone``, else in float32; the parameters, the
    heads and the logits are float32 either way.  ``remat_units``
    rematerializes its bottlenecks in the backward."""
    spec = get_dataset(cfg.dataset)
    return get_model(
        cfg.backbone, num_classes=spec.num_classes, pooling=cfg.pooling,
        rank=cfg.rank, num_joints=spec.num_joints,
        bn_momentum=cfg.bn_momentum, image_size=cfg.image_size,
        freeze_bn=cfg.freeze_bn, generator=generator, device=device,
        dtype=torch.bfloat16 if cfg.bf16_backbone else torch.float32,
        remat_units=cfg.remat_units)


# -- optimizer ----------------------------------------------------------------

def make_learning_rate(cfg: config_lib.TrainConfig) -> Callable[[int], float]:
    """``step -> lr``, the optax schedule of the JAX package: constant,
    cosine (to 0 over ``num_steps - warmup_steps``) or slim's staircase
    exponential decay, after a linear warmup from 0 when
    ``warmup_steps``."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        def sched(step):
            return lr
    elif cfg.lr_schedule == "cosine":
        decay_steps = cfg.num_steps - cfg.warmup_steps
        if decay_steps <= 0:
            raise ValueError("the cosine schedule needs num_steps > "
                             "warmup_steps")

        def sched(step):
            frac = min(step, decay_steps) / decay_steps
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    elif cfg.lr_schedule == "exponential":
        def sched(step):
            return lr * cfg.lr_decay_rate ** (step // cfg.lr_decay_steps)
    else:
        raise ValueError(cfg.lr_schedule)
    if not cfg.warmup_steps:
        return sched
    warmup, after = cfg.warmup_steps, sched

    def warmed(step):
        return lr * step / warmup if step < warmup else after(step - warmup)
    return warmed


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> whether weight decay applies: conv and dense
    kernels, ``attn_w`` and ``sal_w``; not BN scale and offset, biases,
    ``attn_b`` or ``sal_b`` (the JAX package's ``_decay_mask``)."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            key = f"{mod_name}.{name}" if mod_name else name
            mask[key] = name in ("attn_w", "sal_w") or (
                name == "weight" and isinstance(mod, (nn.Conv2d, nn.Linear)))
    return mask


def optimizer_param_names(model: nn.Module) -> list[str]:
    """The parameter names in the order of the optimizer's state indices:
    the decayed ones, then the rest, each in the model's order."""
    mask = decay_mask(model)
    names = [n for n, _ in model.named_parameters()]
    return ([n for n in names if mask[n]]
            + [n for n in names if not mask[n]])


def make_optimizer(cfg: config_lib.TrainConfig, model: nn.Module,
                   tensors: dict[str, torch.Tensor] | None = None
                   ) -> torch.optim.Optimizer:
    """SGD with momentum (or AdamW) over two groups: the decayed
    parameters of :func:`decay_mask` and the rest.  The JAX package's
    chain is clip -> decayed weights -> SGD: the step clips the gradients
    before ``step()``, which adds the decay and then the momentum; it also
    sets each step's learning rate.  ``tensors`` (by parameter name)
    replaces the parameters it names (ZeRO-1's slices)."""
    mask = decay_mask(model)
    named = [(n, (tensors or {}).get(n, p))
             for n, p in model.named_parameters()]
    groups = [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in named if not mask[n]],
         "weight_decay": 0.0},
    ]
    if cfg.optimizer == "momentum":
        return torch.optim.SGD(groups, lr=cfg.learning_rate,
                               momentum=cfg.momentum, dampening=0.0)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(cfg.optimizer)


# -- losses -------------------------------------------------------------------

def classification_loss(logits, labels, *, multi_label: bool,
                        label_smoothing: float = 0.0, mask=None,
                        count=None):
    """Softmax cross entropy of integer labels (MPII, HMDB) or per-class
    sigmoid cross entropy of multi-hot labels (HICO), averaged over the
    batch or over the examples ``mask`` keeps.  ``count`` replaces that
    count (the rows, or the mask's sum) by one taken over more rows than
    these: a data-parallel rank's loss is then its share of the global
    mean."""
    if multi_label:
        per = F.binary_cross_entropy_with_logits(
            logits, labels.to(logits.dtype), reduction="none").sum(-1)
    else:
        per = F.cross_entropy(logits, labels.long(), reduction="none",
                              label_smoothing=label_smoothing)
    if mask is not None:
        mask = mask.to(per.dtype)
        n = mask.sum() if count is None else count
        return (per * mask).sum() / n.clamp(min=1.0)
    return per.mean() if count is None else per.sum() / count


def pose_targets(batch: Mapping[str, torch.Tensor], *, image_size: int,
                 sigma: float = 1.0):
    """Pose heatmap targets (B, fs, fs, K + 1) at feature-map resolution,
    with the preprocessing's crop and flip (``transform`` (B, 5): scale_y,
    scale_x, offset_y, offset_x, flip) applied to the keypoints, and the
    visibility (B, K + 1).  The last channel is the background,
    1 - the strongest joint response."""
    fs = feature_size(image_size)
    stride = image_size / fs
    t = batch["transform"]
    kps, vis = hm.transform_keypoints(
        batch["keypoints"], batch["visibility"], scale_y=t[:, 0],
        scale_x=t[:, 1], offset_y=t[:, 2], offset_x=t[:, 3],
        flip=t[:, 4] > 0, width=image_size)
    heat = hm.render_gaussian_heatmaps(kps / stride, vis, fs, fs,
                                       sigma=sigma)
    bg = torch.clamp(1.0 - heat.amax(dim=-1, keepdim=True), 0.0, 1.0)
    vis = vis.to(torch.float32)
    return (torch.cat([heat, bg], dim=-1),
            torch.cat([vis, torch.ones_like(vis[:, :1])], dim=-1))


def make_loss_fn(spec: DatasetSpec, cfg: config_lib.TrainConfig,
                 group=None):
    """``loss_fn(model, batch, train) -> (total, metrics)``.  With
    ``train`` the model runs in train mode (batch norm normalizes with the
    batch statistics and moves its running ones, unless ``freeze_bn``);
    metrics are detached device scalars ``loss/cls``, ``loss/pose`` (pose
    attention on a dataset with pose) and ``loss/total``.

    With ``group`` (the data axis's process group) each count a loss
    divides by (the rows or the mask's sum, the visible joints) is summed
    over the group first, in one all-reduce, so that the loss is this
    rank's share of the global batch's loss."""
    with_pose = cfg.pooling == "pose_attention" and spec.has_pose

    def global_counts(batch, visb):
        mask = batch.get("mask")
        local = [mask.to(torch.float32).sum() if mask is not None else
                 torch.tensor(float(batch["label"].shape[0]),
                              device=batch["label"].device)]
        if with_pose:
            local.append(visb.sum())
        counts = torch.stack(local).detach()
        torch.distributed.all_reduce(counts, group=group)
        return counts

    def loss_fn(model: ActionModel, batch, train: bool):
        model.train(train)
        if with_pose:
            target, visb = pose_targets(batch, image_size=cfg.image_size)
        counts = (global_counts(batch, visb if with_pose else None)
                  if group is not None else [None, None])
        out = model(normalize_images(batch["image"]))
        total = classification_loss(
            out["logits"], batch["label"], multi_label=spec.multi_label,
            label_smoothing=cfg.label_smoothing, mask=batch.get("mask"),
            count=counts[0])
        metrics = {"loss/cls": total.detach()}
        if with_pose:
            pose = hm.pose_l2_loss(out["pose_heatmaps"], target, visb,
                                   count=counts[1])
            metrics["loss/pose"] = pose.detach()
            total = total + cfg.pose_loss_weight * pose
        metrics["loss/total"] = total.detach()
        return total, metrics

    return loss_fn


# -- state and step -----------------------------------------------------------

def create_state(cfg: config_lib.TrainConfig, *, device=None,
                 variables: tuple[Mapping, Mapping] | None = None,
                 mesh=None) -> tuple[TrainState, DatasetSpec]:
    """The train state on ``device`` (default ``cuda``) and the dataset.
    The weights are drawn as Flax draws them from ``cfg.seed``, through
    an explicit ``torch.Generator``, or come from ``variables``, Flax-layout
    ``(params, batch_stats)`` arrays carried across by the weight bridge.

    ``cfg.init_checkpoint`` then overlays pretrained weights, the heads
    excluded (the reference's fine-tune init): a file path is a TF-slim
    checkpoint (V2 prefix or V1 file), converted on the fly; a directory
    is a port ``CheckpointManager`` directory of an earlier run, whose
    latest step gives the backbone's parameters and BN statistics.

    With a ``mesh`` the state is this rank's part of the mesh's state, by
    the plan of :func:`parallel.mesh.state_shardings`: batch norm reduces
    over the data axis, the head keeps its class shard over a model axis,
    and with ``zero1`` the optimizer keeps this rank's slices."""
    spec = get_dataset(cfg.dataset)
    generator = torch.Generator().manual_seed(cfg.seed)
    model = build_model(cfg, device=device, generator=generator)
    if variables is not None:
        load_flax_variables(model, *variables)
    elif cfg.freeze_bn and not cfg.init_checkpoint:
        # frozen BN normalizes with the RUNNING stats; without a
        # pretrained init those are the (0, 1) init values
        log.warning(
            "freeze_bn=True with no init_checkpoint: BN will normalize "
            "with init-value running stats; the fine-tune presets expect "
            "an ImageNet/slim init_checkpoint")
    if cfg.init_checkpoint:
        if os.path.isdir(cfg.init_checkpoint):
            restored = ckpt_lib.restore_for_eval(
                ckpt_lib.make_manager(cfg.init_checkpoint))
            if restored is None:
                raise ValueError(
                    f"no checkpoint steps under {cfg.init_checkpoint}")
            converted = {"params": restored.params,
                         "batch_stats": restored.batch_stats}
        else:
            converted = ckpt_lib.convert_slim_checkpoint(
                cfg.init_checkpoint, model_scope=cfg.backbone)
        params, batch_stats = state_dict_to_flax(model.state_dict())
        merged = ckpt_lib.merge_pretrained(
            {"params": params, "batch_stats": batch_stats}, converted,
            exclude=("head", "pose_head"))
        load_flax_variables(model, merged["params"], merged["batch_stats"])
    plan = None
    if mesh is not None:
        plan = _parallelize(model, cfg, mesh)
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if cfg.ema_decay else None)
    return TrainState(step=0, model=model,
                      optimizer=_optimizer(cfg, model, mesh, plan),
                      ema_params=ema, mesh=mesh, plan=plan), spec


def _parallelize(model: ActionModel, cfg: config_lib.TrainConfig,
                 mesh) -> mesh_lib.ShardingPlan:
    """Set ``model`` up for its place on ``mesh``, in place, and return
    the plan: batch norm reduces over the data axis (when it has more than
    one rank), and the head keeps its class shard where the plan shards
    it."""
    model_axis = mesh_lib.model_axis_of(mesh)
    plan = mesh_lib.state_shardings(
        mesh, model, model_axis=model_axis,
        zero1_axis="data" if cfg.zero1 else None)
    if mesh_lib.axis_size(mesh, "data") > 1:
        group = mesh_lib.axis_group(mesh, "data")
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.sync_group = group
    if any(pl.kind == "model" for pl in plan.params.values()):
        model.head.shard_classes(mesh_lib.axis_group(mesh, "model"),
                                 mesh_lib.axis_index(mesh, "model"),
                                 mesh_lib.axis_size(mesh, "model"))
    return plan


def _optimizer(cfg, model, mesh, plan):
    names = optimizer_param_names(model)
    if plan is None or not any(plan.opt_state[n].kind == "zero1"
                               for n in names):
        return make_optimizer(cfg, model)
    params = dict(model.named_parameters())

    def make_inner(tensors):
        return make_optimizer(cfg, model, dict(zip(names, tensors)))

    return Zero1Optimizer(
        make_inner, names, [params[n] for n in names],
        [plan.opt_state[n] for n in names], mesh_lib.axis_group(mesh, "data"),
        mesh_lib.axis_index(mesh, "data"), mesh_lib.axis_size(mesh, "data"))


def apply_gradients(state: TrainState, cfg: config_lib.TrainConfig,
                    schedule: Callable[[int], float]) -> torch.Tensor:
    """One update of ``state`` in place from the gradients in the
    parameters' ``.grad``, in the JAX package's order: global-norm clip,
    then the optimizer (decayed weights, then momentum) at
    ``schedule(state.step)``, then the EMA.  Returns the global norm of the
    gradients before the clip, on the device."""
    model, opt = state.model, state.optimizer
    params = list(model.parameters())
    for p in params:                # a parameter the loss did not reach
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = _global_norm(state, grads)
    if cfg.grad_clip_norm:
        torch._foreach_mul_(
            grads, torch.clamp(cfg.grad_clip_norm / norm, max=1.0))
    lr = schedule(state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1
    if state.ema_params is not None:
        # TF ExponentialMovingAverage(num_updates=step): the decay is
        # min(decay, (1+t)/(10+t)), in float32 as the JAX package
        t = np.float32(state.step)
        d = float(min(np.float32(cfg.ema_decay),
                      (np.float32(1) + t) / (np.float32(10) + t)))
        named = dict(model.named_parameters())
        ema = list(state.ema_params.values())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(
            ema, [named[n].detach() for n in state.ema_params],
            alpha=1.0 - d)
    return norm


def _global_norm(state: TrainState, grads) -> torch.Tensor:
    """The global norm of the gradients; under tensor parallelism the
    class shards' squares are summed over the model axis first."""
    plan = state.plan
    if plan is None or plan.model_size <= 1:
        return torch.nn.utils.get_total_norm(grads)
    sharded = [plan.params[n].kind == "model"
               for n, _ in state.model.named_parameters()]
    whole = torch.nn.utils.get_total_norm(
        [g for g, s in zip(grads, sharded) if not s]).square()
    shard = torch.nn.utils.get_total_norm(
        [g for g, s in zip(grads, sharded) if s]).square()
    torch.distributed.all_reduce(
        shard, group=mesh_lib.axis_group(state.mesh, "model"))
    return (whole + shard).sqrt()


def make_train_step(spec: DatasetSpec, cfg: config_lib.TrainConfig,
                    mesh=None):
    """``step_fn(state, batch) -> (state, metrics)``: one update of
    ``state`` in place from a batch of tensors on the model's device.

    With ``grad_accum_steps`` the batch splits into that many
    microbatches, run in turn: batch norm's running statistics chain
    through them, and the gradients and metrics are their means.  Metrics
    (the losses and ``grad_norm``, the global norm before the clip) stay
    on the device.

    With a ``mesh`` (and a state made for it, ``create_state(mesh=)``) the
    batch is this rank's rows: the losses divide by global counts, the
    gradients are all-reduced over the data axis before the clip, and the
    metrics are the global batch's, equal on every rank."""
    data = mesh_lib.axis_size(mesh, "data")
    group = mesh_lib.axis_group(mesh, "data")
    loss_fn = make_loss_fn(spec, cfg, group)
    schedule = make_learning_rate(cfg)
    accum = max(int(cfg.grad_accum_steps or 1), 1)

    def step_fn(state: TrainState, batch: Mapping[str, torch.Tensor]):
        b = batch["image"].shape[0]
        if b % accum:
            if mesh is not None:
                raise ValueError(
                    f"microbatch {b * data / accum:g} (batch {b * data} / "
                    f"accum {accum}) not divisible by the data-axis size "
                    f"{data}")
            raise ValueError(f"per-host batch {b} not divisible by "
                             f"grad_accum_steps {accum}")
        if state.mesh is not mesh:
            raise ValueError("the state was made for another mesh than "
                             "the step's (create_state(mesh=...))")
        m = b // accum
        state.optimizer.zero_grad(set_to_none=True)
        micro = []
        for i in range(accum):
            mb = ({k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                  if accum > 1 else batch)
            total, metrics = loss_fn(state.model, mb, True)
            total.backward()
            micro.append(metrics)
        if accum > 1:
            torch._foreach_div_([p.grad for p in state.model.parameters()
                                 if p.grad is not None], float(accum))
            metrics = {k: torch.stack([mt[k] for mt in micro]).mean()
                       for k in micro[0]}
        if group is not None:
            for p in state.model.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            mesh_lib.all_reduce_flat(
                [p.grad for p in state.model.parameters()], group)
            # each rank's losses are its shares: their sum is the global
            # batch's
            keys = sorted(metrics)
            shares = torch.stack([metrics[k] for k in keys])
            torch.distributed.all_reduce(shares, group=group)
            metrics = dict(zip(keys, shares.unbind()))
        metrics["grad_norm"] = apply_gradients(state, cfg, schedule)
        return state, metrics

    return step_fn


# -- loop ---------------------------------------------------------------------

def batch_to_device(batch: Mapping, device) -> dict[str, torch.Tensor]:
    """A batch as tensors on ``device``: host arrays to a CUDA device
    through pinned memory, without waiting for the copy; tensors already
    on ``device`` pass through untouched."""
    return pipeline.to_device(batch, torch.device(device))


def _resume(cfg: config_lib.TrainConfig, state: TrainState,
            manager) -> None:
    """Restore the latest step of ``manager`` into ``state``, reconciling
    an ``ema_decay`` toggled between the saved run and this one: off -> on
    seeds the EMA from the restored parameters; on -> off leaves the saved
    EMA unused (and not saved again)."""
    has_ema = "ema_params" in ckpt_lib.saved_tree_keys(manager)
    seed_ema = bool(cfg.ema_decay) and not has_ema
    if seed_ema:
        log.warning(
            "resume: checkpoint has no ema_params but ema_decay=%s — "
            "seeding EMA from the restored params at this step",
            cfg.ema_decay)
        state.ema_params = None
    elif has_ema and not cfg.ema_decay:
        log.warning(
            "resume: checkpoint carries ema_params but ema_decay is "
            "unset — the saved EMA will not be updated or re-saved")
    ckpt_lib.restore(manager, state)
    if seed_ema:
        state.ema_params = {n: p.detach().clone()
                            for n, p in state.model.named_parameters()}
    log.info("resumed from checkpoint at step %d", state.step)


def _train_input(cfg: config_lib.TrainConfig, spec: DatasetSpec,
                 train_iter: Iterable | None, dev: torch.device, *,
                 batch_size: int, shard_index: int = 0,
                 shard_count: int = 1):
    """``(batches, stateful, owned)``: the iterator the loop pulls from
    (prefetched to ``dev``, echoed with ``data_echo``), the outermost
    wrapper whose state is checkpointed (None for a stateless iterator)
    and the pipeline this call built (None for the caller's), which reads
    shard ``shard_index`` of ``shard_count`` of the records in batches of
    ``batch_size`` rows."""
    owned = None
    if train_iter is None:
        if not cfg.train_pattern:
            raise ValueError("no train_iter and no cfg.train_pattern")
        video_sampling = spec.is_video and cfg.video_frame_sampling
        owned = train_iter = grain_pipeline.make_train_iterator(
            cfg.train_pattern, spec, batch_size=batch_size,
            shard_index=shard_index, shard_count=shard_count,
            image_size=cfg.image_size, resize_min=cfg.resize_min_resolved,
            resize_max=cfg.resize_max_resolved, seed=cfg.seed,
            num_workers=cfg.grain_workers,
            transfer_uint8=cfg.transfer_uint8,
            video_sampling=video_sampling, device=dev,
            **({"clip_frames": cfg.clip_frames} if video_sampling else {}))
    if hasattr(train_iter, "get_state"):
        # the state checkpointed is the last CONSUMED batch's, not the
        # prefetch position, so the resume is exact
        batches = stateful = pipeline.StatefulPrefetchIterator(
            train_iter, device=dev)
    else:
        batches, stateful = pipeline.prefetch_to_device(
            train_iter, device=dev), None
    if cfg.data_echo > 1:
        # above the prefetch: a repeat reuses the batch on the device
        batches = pipeline.EchoIterator(batches, cfg.data_echo)
        if stateful is not None:
            stateful = batches
    return batches, stateful, owned


def train(cfg: config_lib.TrainConfig, *, train_iter: Iterable | None = None,
          num_steps: int | None = None, hooks=(), device=None,
          checkpoint_manager=None, stop_event=None):
    """Run the training loop on ``device`` (default ``cuda``) up to
    ``num_steps`` (default ``cfg.num_steps``) updates, over ``train_iter``
    (an iterator of batches of numpy arrays or tensors) or, without one,
    over the records of ``cfg.train_pattern`` through the port's input
    pipeline.  Batches are prefetched to the device; with ``data_echo`` >
    1 each feeds that many steps.  Every ``cfg.log_every`` steps and at
    the last the metrics come to the host, are logged and join the
    returned history; ``hooks`` are called ``hook(step, state, metrics)``
    after every step.  Returns ``(state, history)``.

    With a ``checkpoint_manager`` the run resumes from its latest step
    (the learning rate keyed on the restored step), and saves every
    ``cfg.checkpoint_every`` steps, at the last step and on a stop; a
    stateful iterator (the pipeline's, or one with
    ``get_state``/``set_state``) has its JSON state saved beside each step
    and restored with it into the outermost wrapper.  Saves are written
    in the background while the next steps run; the run waits for the
    last one before it returns, on a stop too.  ``stop_event`` (a
    ``threading.Event``): when set, by the caller or by the SIGTERM
    handler installed here (on the main thread, with a manager), the loop
    checkpoints the step in flight and returns.

    In a job of several processes (``parallel.multihost.setup``) each
    process trains on its share of ``cfg.batch_size`` (the global batch)
    and reads its shard of the records; with a ``mesh_shape`` of more
    than one device the processes form the mesh (``parallel/mesh.py``)
    and train as one.  Saves are collective (process 0 writes the state,
    each process its own iterator file), and the stop is agreed on
    across processes one step late (``multihost.FlagAllReduce``), so that
    every process checkpoints the same step."""
    _check_clips(cfg, get_dataset(cfg.dataset))
    dev = resolve_device(device)
    world, rank = multihost.process_count(), multihost.process_index()
    mesh = None
    if world > 1 and math.prod(cfg.mesh_shape or (1,)) > 1:
        mesh = mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    # ranks along a model axis read the same rows
    shards = mesh_lib.axis_size(mesh, "data") if mesh is not None else world
    shard = mesh_lib.axis_index(mesh, "data") if mesh is not None else rank
    if cfg.batch_size % shards:
        raise ValueError(f"global batch_size {cfg.batch_size} not divisible "
                         f"by process_count {shards}")
    state, spec = create_state(cfg, device=dev, mesh=mesh)
    resume_step = (checkpoint_manager.latest_step()
                   if checkpoint_manager is not None else None)
    if resume_step is not None:
        _resume(cfg, state, checkpoint_manager)
    step_fn = make_train_step(spec, cfg, mesh)

    batches, stateful_iter, owned = _train_input(
        cfg, spec, train_iter, dev, batch_size=cfg.batch_size // shards,
        shard_index=shard, shard_count=shards)
    if stateful_iter is not None and resume_step is not None:
        iter_path = _grain_state_path(checkpoint_manager, resume_step, rank)
        if iter_path.exists():
            stateful_iter.set_state(_normalize_iter_state(
                json.loads(iter_path.read_text()), cfg.data_echo))
            log.info("resumed data iterator from %s", iter_path)

    def save_checkpoint(at_step: int):
        # queued: the write runs behind the next steps (checkpoint.py)
        ckpt_lib.save(checkpoint_manager, state)
        if stateful_iter is not None:
            _grain_state_path(checkpoint_manager, at_step, rank).write_text(
                json.dumps(stateful_iter.get_state()))
            if rank == 0:
                _gc_grain_state(checkpoint_manager, keep_step=at_step)

    # Preemptions arrive as SIGTERM.  The handler only sets the flag; the
    # loop finishes the step in flight, saves it and returns, so that the
    # restart resumes from the preemption point.
    if stop_event is None:
        stop_event = threading.Event()
    prev_handler = None
    if checkpoint_manager is not None:
        try:
            prev_handler = signal.signal(
                signal.SIGTERM, lambda sig, frame: stop_event.set())
        except ValueError:
            pass  # not the main thread: rely on the caller's stop_event

    num_steps = num_steps or cfg.num_steps
    history = []
    t0 = time.time()
    flag_reduce = multihost.FlagAllReduce()
    pending_flag = flag_reduce.dispatch(False)
    try:
        for _ in range(max(num_steps - state.step, 0)):
            batch = batch_to_device(next(batches), dev)
            state, metrics = step_fn(state, batch)
            step = state.step
            if step % cfg.log_every == 0 or step == num_steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                log.info("step %d %s (%.2f s)", step, metrics,
                         time.time() - t0)
                history.append({"step": step, **metrics})
            for hook in hooks:
                hook(step, state, metrics)
            # read the stop AFTER the hooks, so that a stop raised during
            # this step (signal or hook) checkpoints THIS step; several
            # processes agree on last step's flags instead
            if world == 1:
                stopping = stop_event.is_set()
            else:
                stopping = flag_reduce.read(pending_flag)
                pending_flag = flag_reduce.dispatch(stop_event.is_set())
            if checkpoint_manager is not None and (
                    step % cfg.checkpoint_every == 0 or step == num_steps
                    or stopping):
                save_checkpoint(step)
            if stopping:
                log.warning(
                    "stop requested (SIGTERM/preemption): checkpointed at "
                    "step %d and exiting cleanly", step)
                break
        if checkpoint_manager is not None:
            # the last save commits (or raises) before the run returns
            checkpoint_manager.wait_until_finished()
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        if owned is not None:
            owned.close()
    return state, history


def _check_clips(cfg: config_lib.TrainConfig, spec: DatasetSpec) -> None:
    """The JAX package's config errors of clip training: clips need a
    video dataset, and the Grain pipeline with per-epoch frame sampling
    (the TSN sampler runs on the video index)."""
    if cfg.clip_frames <= 1:
        return
    if not spec.is_video:
        raise ValueError(
            f"clip_frames={cfg.clip_frames} requires a video dataset "
            f"(per-frame records with video ids); {cfg.dataset} is not one")
    if cfg.input_pipeline != "grain" or not cfg.video_frame_sampling:
        raise ValueError(
            f"clip_frames={cfg.clip_frames} requires "
            "input_pipeline='grain' with video_frame_sampling=True (TSN "
            "segment sampling runs on the random-access video index)")


def _normalize_iter_state(state, data_echo: int):
    """Reconcile a checkpointed iterator state with the CURRENT
    ``data_echo`` (the toggle may change across a restart).  Echo states
    are ``{"inner_before", "phase"}``, plain ones the inner iterator's
    own; echo->echo and plain->plain pass through, plain->echo starts at
    phase 0, echo->plain resumes from the inner position and drops the
    remaining repeats of a mid-echo batch (logged)."""
    is_echo = (isinstance(state, dict)
               and set(state) == {"inner_before", "phase"})
    if data_echo > 1:
        return state if is_echo else {"inner_before": state, "phase": 0}
    if is_echo:
        if state["phase"]:
            log.warning(
                "resuming with data_echo=1 from a mid-echo checkpoint: "
                "the in-flight batch's remaining %d echoes are dropped",
                state["phase"])
        return state["inner_before"]
    return state


def _grain_state_path(manager, step: int,
                      process_index: int = 0) -> pathlib.Path:
    """Process ``process_index``'s iterator state file beside the step
    directories, named as the JAX package names it: each process reads its
    own shard, and saves and restores its own position."""
    return (pathlib.Path(manager.directory)
            / f"grain_iter_{step}_p{process_index}.json")


def _gc_grain_state(manager, keep_step: int) -> None:
    """Drop the iterator state files of the steps that the save of
    ``keep_step`` (just queued) prunes, so that no stale file pairs with a
    deleted step, without waiting for that save."""
    keep = set(manager.retained_steps(keep_step))
    for p in pathlib.Path(manager.directory).glob("grain_iter_*.json"):
        m = re.fullmatch(r"grain_iter_(\d+)(?:_p\d+)?\.json", p.name)
        if m and int(m.group(1)) not in keep:
            p.unlink(missing_ok=True)
