"""Driver ``train``: ``train.train`` of the port through its own input
pipeline, from seeded records, timed by a hook and stopped by its
``stop_event``; its first three steps judged against the plain reference.

Traffic parameters (``traffic/<workload>.json``): ``records`` (written
at set-up from ``pool_images`` JPEGs of ``mix`` at ``jpeg_quality``),
``warm_steps`` (steps before the window: the build, cuDNN's choices,
the first three steps that are judged), ``trace`` (``skip_steps`` into
the window, then ``steps`` traced) and ``check`` (``limits``).

Set-up builds one run: ``train.train`` makes its state from the seeded
weights (handed to its ``create_state`` through the ``variables`` it
takes) and trains on; a hook reads the losses of steps 1-3, the momentum
after step 1 (what the optimizer took in: the clipped gradient plus the
decay) and the parameters' change after step 3, then opens the window on
a ``torch.cuda.synchronize()``, counts the steps and closes it on another
once ``--seconds`` have passed.  The window's images are the steps
completed in it times the global batch.  The hook keeps each window
step's loss as the step left it (a tensor on the card, read only after
the window): a step whose loss is not finite counts as failed, and the
window's losses and the parameters it ends with have to be finite.

The judgement has two stages.  The batches the first three steps got
(copied on their way to the step) are held against the reference's own
(OpenCV decode, the stream's documented order and geometry): labels
exactly, pixels by their mean gap.  The reference then follows the three
steps from the same seeded weights on those same batches: nvJPEG and
OpenCV decode a few pixels a level apart, and a train-mode step of a
random ResNet turns that into gaps as wide as bfloat16's, so the step is
judged on the program's own inputs and the decode by itself.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import threading
import time

import numpy as np

from bench_h100 import common, roofline
from bench_h100.cell import make_weights, num_classes, port_config
from bench_h100.generators import images as gen_images
from bench_h100.generators import records as gen_records
from bench_h100.generators import weights as gen_weights
from bench_h100.reference import compare
from bench_h100.reference import model as ref_model
from bench_h100.reference import preprocess as ref_pre
from bench_h100.reference import train as ref_train

JUDGED_STEPS = 3


def key(path: tuple) -> str:
    return "/".join(path)


class WindowHook:
    """``hook(step, state, metrics)`` of ``train.train``: the judged
    readings of steps 1-3, then the timed window."""

    def __init__(self, *, init: dict, warm_steps: int, seconds: float,
                 stop: threading.Event, sync, tracer=None, trace=None):
        self.init, self.warm, self.seconds = init, warm_steps, seconds
        self.stop, self.sync, self.tracer = stop, sync, tracer
        self.trace = trace or {}
        self.losses, self.taken, self.change = [], {}, {}
        self.window_losses = []
        self.bn_update = {}
        self.window_start = self.window_end = None
        self.steps = 0

    def _named(self, state):
        out = {}
        for name, p in state.model.named_parameters():
            coll, path = gen_weights.port_name_to_path(name)
            if coll == "params":
                out[key(path)] = p
        return out

    def __call__(self, step, state, metrics):
        if step <= JUDGED_STEPS:
            self.losses.append(float(metrics["loss/total"]))
        if step == 1:
            opt = state.optimizer
            # a step that never reached the optimizer left no momentum:
            # it took in nothing
            self.taken = compare.norms(
                {k: opt.state[p].get("momentum_buffer", p.new_zeros(()))
                 for k, p in self._named(state).items()})
            self.bn_update = {
                key(path): (b.detach() - self.init[key(path)]).cpu()
                for name, b in state.model.named_buffers()
                for coll, path in [gen_weights.port_name_to_path(name)]
                if coll == "batch_stats" and path[-1] == "mean"}
        if step == JUDGED_STEPS:
            self.change = compare.norms(
                {k: p.detach() - port_layout(self.init[k])
                 for k, p in self._named(state).items()})
        if step == self.warm:
            self.sync()
            self.window_start = time.monotonic()
            return
        if self.window_start is None or self.window_end is not None:
            return
        self.steps += 1
        self.window_losses.append(metrics["loss/total"])
        if self.tracer is not None:
            if self.steps == self.trace.get("skip_steps", 0) + 1:
                self.tracer.start()
            elif self.steps == (self.trace.get("skip_steps", 0) + 1
                                + self.trace.get("steps", 0)):
                self.tracer.stop()
        if time.monotonic() - self.window_start >= self.seconds:
            if self.tracer is not None and self.tracer.active:
                self.tracer.stop()
            self.sync()
            self.window_end = time.monotonic()
            self.stop.set()


def port_layout(t):
    """A Flax-layout leaf in the port's layout (an HWIO conv kernel as
    OIHW; the head keeps the Flax layouts)."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def recipe(cfg) -> ref_train.Recipe:
    return ref_train.Recipe(
        stages=gen_weights.STAGES[cfg.backbone],
        learning_rate=cfg.learning_rate, momentum=cfg.momentum,
        weight_decay=cfg.weight_decay, lr_decay_rate=cfg.lr_decay_rate,
        lr_decay_steps=cfg.lr_decay_steps, grad_clip_norm=cfg.grad_clip_norm,
        ema_decay=cfg.ema_decay, bn_decay=cfg.bn_momentum)


def reference_batches(cfg, datas: list[bytes], labels) -> list:
    """The reference's own first training batches of the records: OpenCV
    decode and the stream's documented order and geometry."""
    return ref_pre.train_batches(
        datas, labels, seed=cfg.seed, steps=JUDGED_STEPS,
        batch=cfg.batch_size, out_size=cfg.image_size,
        resize_min=cfg.resize_min_resolved,
        resize_max=cfg.resize_max_resolved)


def reference_readings(cfg, seed: int, batches: list, device,
                       dtype=None) -> dict:
    """The reference's losses of steps 1-3 over ``batches`` (``[(uint8
    images, labels)]``), what its optimizer took in at step 1, its first
    gradients, and its parameters' change after step 3, from the seeded
    weights."""
    import torch
    dtype = dtype or torch.float32
    params, stats = make_weights(cfg, seed, device)
    trainer = ref_train.Trainer(params, stats, recipe(cfg))
    init = {p: t.clone() for p, t in trainer.params.items()}
    stats0 = {p: t.clone() for p, t in trainer.stats.items()}
    del params, stats
    out = {"losses": []}
    with ref_model.exact_float32():
        for k, (imgs, labs) in enumerate(batches[:JUDGED_STEPS]):
            r = trainer.train_step(
                torch.as_tensor(np.asarray(imgs)).to(device),
                torch.as_tensor(np.asarray(labs, np.int64)).to(device),
                dtype)
            out["losses"].append(r["loss"])
            if k == 0:
                out["taken"] = compare.norms(
                    {key(p): t for p, t in r["taken"].items()})
                out["grads"] = compare.norms(
                    {key(p): t for p, t in r["grads"].items()})
                out["bn_update"] = {
                    key(p): (t - stats0[p]).cpu()
                    for p, t in trainer.stats.items() if p[-1] == "mean"}
    out["change"] = compare.norms(
        {key(p): trainer.params[p] - init[p] for p in init})
    return out


def gaps(program: dict, reference: dict) -> dict:
    """The step's numbers: ``bn_mean_gap``, the median over the batch
    norms of the relative gap between the program's and the reference's
    running-mean updates of step 1 (the forward's batch statistics); the
    first step's loss gap and the worst of the three (relative); the
    worst leaf's gap of what the optimizer took in
    at step 1 and of the change after step 3 (over the leaves the
    reference's first gradient moves, ``compare.moved_leaves``), and the
    median leaf's of both.  Which of them are compared is the traffic
    file's ``limits``; the others are reported."""
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]) or not steps:
        steps.append(float("inf"))
    keep = compare.moved_leaves(reference["grads"])
    taken, _ = compare.leaf_gap(program["taken"], reference["taken"])
    change, _ = compare.leaf_gap(program["change"], reference["change"],
                                 keep)
    return {"bn_mean_gap": compare.update_gap(program["bn_update"],
                                              reference["bn_update"]),
            "first_loss_gap": steps[0], "loss_gap": max(steps),
            "first_step_gap": taken, "change_gap": change,
            "first_step_median_gap": compare.leaf_gap(
                program["taken"], reference["taken"], median=True)[0],
            "change_median_gap": compare.leaf_gap(
                program["change"], reference["change"], keep,
                median=True)[0]}


def write_records(ctx: common.Context, cfg, path: str):
    tr = ctx.traffic
    pool = gen_images.make_pool(ctx.seed, tr["mix"], int(tr["pool_images"]),
                                int(tr["jpeg_quality"]))
    drawn = gen_records.write(path, pool, int(tr["records"]), ctx.seed,
                              num_classes(cfg))
    datas = [pool[int(i)]["data"] for i in drawn["pool_index"]]
    return datas, drawn["label"]


def run(ctx: common.Context) -> common.Outcome:
    import torch
    from attentionalpoolingaction_torch import train as train_lib
    from bench_h100 import trace as trace_lib
    tr = ctx.traffic
    dev = ctx.device
    path = os.path.join(ctx.tmpdir, "train.tfrecord")
    cfg = port_config(ctx)
    cfg = dataclasses.replace(cfg, seed=ctx.seed, train_pattern=path,
                              num_steps=10 ** 9)
    datas, labels = write_records(ctx, cfg, path)
    params, stats = make_weights(cfg, ctx.seed, dev)
    init = {key(p): t.clone() for p, t in gen_weights.leaves(params)
            + gen_weights.leaves(stats)}
    variables = (gen_weights.to_numpy(params), gen_weights.to_numpy(stats))
    del params, stats
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    stop = threading.Event()
    tracer = trace_lib.Tracer(ctx.tmpdir) if ctx.trace else None
    hook = WindowHook(init=init, warm_steps=int(tr["warm_steps"]),
                      seconds=ctx.seconds, stop=stop, sync=sync,
                      tracer=tracer, trace=tr.get("trace"))
    create, to_device = train_lib.create_state, train_lib.batch_to_device
    train_lib.create_state = functools.partial(create, variables=variables)
    fed = []

    def tap(batch, device):
        # the first batches as the step gets them, copied to the host
        out = to_device(batch, device)
        if len(fed) < JUDGED_STEPS:
            fed.append((out["image"].detach().cpu().numpy(),
                        torch.as_tensor(out["label"]).cpu().numpy()))
        return out
    train_lib.batch_to_device = tap
    try:
        state, _ = train_lib.train(cfg, hooks=[hook], device=dev,
                                   stop_event=stop)
    finally:
        train_lib.create_state = create
        train_lib.batch_to_device = to_device
    del variables
    if hook.window_end is None:
        raise RuntimeError("the run ended before its window closed")
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    window_nonfinite = sum(not np.isfinite(float(x))
                           for x in hook.window_losses)
    nonfinite_params = sum(not bool(torch.isfinite(p).all())
                           for p in state.model.parameters())
    del state, init
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    program = {"losses": hook.losses, "taken": hook.taken,
               "change": hook.change, "bn_update": hook.bn_update}
    found = compare.batch_gaps(fed, reference_batches(cfg, datas, labels))
    reference = reference_readings(cfg, ctx.seed, fed, dev)
    found.update(gaps(program, reference))
    limits = tr["check"]["limits"]
    checks = [common.Check(k, found[k], float(v)) for k, v in limits.items()]
    # exact: the window's steps and the state they leave are finite
    checks += [common.Check("window_nonfinite_losses",
                            float(window_nonfinite), 0.0),
               common.Check("nonfinite_params", float(nonfinite_params), 0.0)]
    window = hook.window_end - hook.window_start
    images = hook.steps * cfg.batch_size
    layer_ctx = {"images": images, "window_s": window,
                 "train_flops": roofline.train_flops(
                     cfg.backbone, cfg.image_size, num_classes(cfg),
                     cfg.rank),
                 "peak_flops": roofline.PEAK_FLOPS[ctx.config_file["peak"]],
                 "head_shape": head_shape(cfg, cfg.batch_size)}
    return common.Outcome(
        end_to_end={"train_images_per_s": images / window},
        window_start=hook.window_start, attempted=hook.steps,
        failed=window_nonfinite, checks=checks,
        memory_peak_bytes=peak, device_count=1, layer_ctx=layer_ctx,
        trace=tracer.summary if tracer else None,
        notes={"losses": hook.losses,
               "reference_losses": reference["losses"],
               **{k: v for k, v in found.items() if k not in limits}})


def head_shape(cfg, batch: int) -> dict:
    """The head kernels' shape a step: batch, positions, features,
    classes, rank and X's bytes an element."""
    return {"b": batch, "n": roofline.feature_size(cfg.image_size) ** 2,
            "f": roofline.NUM_FEATURES, "c": num_classes(cfg), "p": cfg.rank,
            "x_bytes": 2 if cfg.bf16_backbone else 4}
