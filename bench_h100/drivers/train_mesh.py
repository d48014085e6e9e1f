"""Driver ``train_mesh``: ``train.train`` of the port data-parallel over
the cell's cards, one process a card joined over NCCL, from seeded
records; the first three steps judged against the plain reference with
frozen batch norm (``reference/train_frozen.py``).

Traffic parameters (``traffic/<workload>.json``): as the ``train``
driver's (``records``, ``pool_images``, ``mix``, ``jpeg_quality``,
``warm_steps``, ``trace``, ``check``), and ``timeout_s``, the longest a
run's workers may take.

This process is the launcher.  It writes the records once, then starts
one worker a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` = the rank's
card, ``MASTER_ADDR``, ``MASTER_PORT``), each running this module with
``--worker``.  When any worker exits non-zero, or the workers outlive
``timeout_s``, every worker is killed and the run fails: a lost peer
leaves the others blocked in a collective.

A worker joins the job (``parallel.multihost.setup``), makes the cell's
seeded weights on its card, checks at step 0 that its state holds the
same bits as rank 0's, and runs ``train.train`` on its shard of the
records (the stream sharded by the data coordinate, as ``train.train``
shards it) with the ``train`` driver's ``WindowHook``.  Rank 0 opens and
closes the window on ``torch.cuda.synchronize()`` and stops the job
through ``train.train``'s own stop (agreed across the ranks one step
late, ``multihost.FlagAllReduce``); the other ranks keep no window.  The
window's images are the steps completed in it times the global batch.
Traced, rank 0 profiles its part of the window and keeps its spans.
After the run each worker writes what it read to the run's directory:
the batches its first three steps got, its state's replica gap to rank
0's, whether a running statistic moved, and (rank 0) the judged readings,
the window, the trace's summary and the span totals.

The judgement runs here, after the workers have exited, on the first
card: each rank's batches against the reference's OpenCV decode of that
rank's rows (pixels by their mean gap, labels exactly), then the
reference's three steps from the same seeded weights on the batches the
ranks got, the global batch in blocks of the ranks' rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import common, roofline  # noqa: E402
from bench_h100 import trace as trace_lib  # noqa: E402
from bench_h100.cell import make_weights, num_classes, port_config  # noqa
from bench_h100.drivers import train as td  # noqa: E402
from bench_h100.generators import weights as gen_weights  # noqa: E402
from bench_h100.reference import compare  # noqa: E402
from bench_h100.reference import model as ref_model  # noqa: E402
from bench_h100.reference import preprocess as ref_pre  # noqa: E402
from bench_h100.reference import train_frozen  # noqa: E402

JUDGED_STEPS = td.JUDGED_STEPS
# seconds between two looks at the workers
POLL_S = 0.2


def mesh_config(ctx: common.Context):
    """The port's configuration of the cell for ``ctx``'s seed, reading
    the run's records, its mesh as a tuple."""
    cfg = port_config(ctx)
    return dataclasses.replace(
        cfg, mesh_shape=tuple(int(s) for s in cfg.mesh_shape),
        seed=ctx.seed, train_pattern=os.path.join(ctx.tmpdir,
                                                  "train.tfrecord"),
        num_steps=10 ** 9)


def world_of(cfg) -> int:
    return math.prod(cfg.mesh_shape)


# -- the launcher ------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_argv(ctx_path: str) -> list[str]:
    """The command line of one worker."""
    return [sys.executable, os.path.abspath(__file__), "--worker", ctx_path]


def _die_with_parent() -> None:
    """In a worker before it runs: the kernel kills it when the launcher
    dies, however the launcher is ended (Linux's ``PR_SET_PDEATHSIG``)."""
    import ctypes
    import signal
    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))


def launch(argv: list[str], world: int, *, logdir: str, timeout: float,
           one_card_each: bool = True) -> None:
    """Run ``world`` processes of ``argv``, joined through torchrun's
    environment (rank r on card r with ``one_card_each``, else all on
    card 0), each writing its output to ``<logdir>/rank<r>.log``.  Returns
    when every one has exited 0; when one exits non-zero, or ``timeout``
    seconds pass first, kills every one that still runs, waits for it and
    raises with that rank's last lines.  A worker also dies with this
    process.  Each worker's ``OMP_NUM_THREADS`` is its share of this
    process's cores unless the environment sets it."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    # each worker's CPU thread pools take its share of the host's cores
    # (torchrun sets 1) unless the caller chose: four pools as wide as the
    # host each oversubscribe it where the workers compute on the CPU
    env.setdefault("OMP_NUM_THREADS",
                   str(max(len(os.sched_getaffinity(0)) // world, 1)))
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(os.path.join(logdir, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                argv, cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=_die_with_parent,
                env=dict(env, RANK=str(rank), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(rank if one_card_each else 0),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))))
        deadline = time.monotonic() + timeout
        why = None
        while why is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                why = (bad[0], f"worker {bad[0]} exited {codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                return
            elif time.monotonic() > deadline:
                late = next(r for r, c in enumerate(codes) if c is None)
                why = (late, f"the workers outlived {timeout:g} s")
            else:
                time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    rank, what = why
    tail = pathlib.Path(logdir, f"rank{rank}.log").read_text()[-6000:]
    raise RuntimeError(f"{what}; every worker was stopped.  Rank {rank}'s "
                       f"last output:\n{tail}")


def run(ctx: common.Context) -> common.Outcome:
    tr = ctx.traffic
    cfg = mesh_config(ctx)
    world = world_of(cfg)
    datas, labels = td.write_records(ctx, cfg, cfg.train_pattern)
    ctx_path = os.path.join(ctx.tmpdir, "context.json")
    with open(ctx_path, "w") as f:
        json.dump(dataclasses.asdict(ctx), f)
    launch(worker_argv(ctx_path), world, logdir=ctx.tmpdir,
           timeout=float(tr["timeout_s"]),
           one_card_each=ctx.device == "cuda")
    ranks = [read_json(ctx.tmpdir, f"rank{r}.json") for r in range(world)]
    fed = [load_batches(ctx.tmpdir, r) for r in range(world)]
    first = ranks[0]
    trace = None
    if ctx.trace:
        with open(os.path.join(ctx.tmpdir, "trace.pkl"), "rb") as f:
            trace = pickle.load(f)
    found = judge(ctx, cfg, datas, labels, first, fed)
    reference_losses = found.pop("reference_losses")
    found["replica_gap"] = max(r["replica_gap"] for r in ranks)
    found["bn_stats_moved"] = float(sum(r["bn_stats_moved"] for r in ranks))
    limits = tr["check"]["limits"]
    checks = [common.Check(k, found[k], float(v)) for k, v in limits.items()]
    # exact: every rank started from rank 0's bits; the window's steps and
    # the states they leave are finite
    checks += [
        common.Check("init_mismatch",
                     float(sum(r["init_mismatch"] for r in ranks)), 0.0),
        common.Check("window_nonfinite_losses",
                     float(first["window_nonfinite"]), 0.0),
        common.Check("nonfinite_params",
                     float(sum(r["nonfinite_params"] for r in ranks)), 0.0)]
    window = first["window_end"] - first["window_start"]
    images = first["steps"] * cfg.batch_size
    layer_ctx = {
        "images": images, "window_s": window, "cards": world,
        "train_flops": roofline.train_flops(
            cfg.backbone, cfg.image_size, num_classes(cfg), cfg.rank),
        "peak_flops": roofline.PEAK_FLOPS[ctx.config_file["peak"]],
        # the head's features are float32 whatever the backbone computes
        # in (models/action_model.py casts them before every head)
        "head_shape": dict(td.head_shape(cfg, cfg.batch_size // world),
                           x_bytes=4),
        "span_totals": first.get("span_totals"),
        "nccl_exposed_s": first.get("nccl_exposed_s"),
        "traced_steps": first.get("traced_steps")}
    return common.Outcome(
        end_to_end={"train_images_per_s": images / window},
        window_start=first["window_start"], attempted=first["steps"],
        failed=first["window_nonfinite"], checks=checks,
        memory_peak_bytes=max(r["memory_peak_bytes"] for r in ranks),
        device_count=world, layer_ctx=layer_ctx, trace=trace,
        notes={"losses": first["losses"],
               "reference_losses": reference_losses,
               "memory_peak_bytes_by_rank": [r["memory_peak_bytes"]
                                             for r in ranks],
               **{k: v for k, v in found.items() if k not in limits}})


def read_json(tmpdir: str, name: str) -> dict:
    with open(os.path.join(tmpdir, name)) as f:
        return json.load(f)


def load_batches(tmpdir: str, rank: int) -> list:
    z = np.load(os.path.join(tmpdir, f"rank{rank}_batches.npz"))
    n = len([k for k in z.files if k.startswith("image")])
    return [(z[f"image{k}"], z[f"label{k}"]) for k in range(n)]


# -- the judgement -----------------------------------------------------------

def reference_batches(cfg, datas, labels, world: int) -> list:
    """Each rank's first training batches as the reference makes them:
    ``[[(uint8 images, labels)] a step] a rank``."""
    return [ref_pre.train_batches(
        datas, labels, seed=cfg.seed, steps=JUDGED_STEPS,
        batch=cfg.batch_size // world, out_size=cfg.image_size,
        resize_min=cfg.resize_min_resolved,
        resize_max=cfg.resize_max_resolved, shard=r, shards=world)
        for r in range(world)]


def global_batches(fed: list) -> list:
    """The global batches of the judged steps, the ranks' rows in rank
    order, from ``[[(images, labels)] a step] a rank``."""
    return [(np.concatenate([f[k][0] for f in fed]),
             np.concatenate([f[k][1] for f in fed]))
            for k in range(min(len(f) for f in fed))]


def reference_readings(cfg, seed: int, batches: list, device, blocks: int,
                       dtype=None) -> dict:
    """The frozen-BN reference's losses of steps 1-3 over the global
    ``batches`` (computed in ``blocks`` blocks of rows), what its
    optimizer took in at step 1, its first gradients and its parameters'
    change after step 3, from the seeded weights."""
    import torch
    dtype = dtype or torch.float32
    params, stats = make_weights(cfg, seed, device)
    trainer = train_frozen.FrozenTrainer(params, stats, td.recipe(cfg),
                                         blocks=blocks)
    del params, stats
    init = {p: t.clone() for p, t in trainer.params.items()}
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
                    {td.key(p): t for p, t in r["taken"].items()})
                out["grads"] = compare.norms(
                    {td.key(p): t for p, t in r["grads"].items()})
    out["change"] = compare.norms(
        {td.key(p): trainer.params[p] - init[p] for p in init})
    return out


def gaps(program: dict, reference: dict) -> dict:
    """The step's numbers, as the ``train`` driver's ``gaps`` reads them
    but for batch norm, which is frozen here: the loss gaps (relative),
    the worst and the median leaf's gap of what the optimizer took in at
    step 1 and of the change after step 3 (over the leaves the
    reference's first gradient moves)."""
    steps = [abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]) or not steps:
        steps.append(float("inf"))
    keep = compare.moved_leaves(reference["grads"])
    return {"first_loss_gap": steps[0], "loss_gap": max(steps),
            "first_step_gap": compare.leaf_gap(
                program["taken"], reference["taken"])[0],
            "change_gap": compare.leaf_gap(
                program["change"], reference["change"], keep)[0],
            "first_step_median_gap": compare.leaf_gap(
                program["taken"], reference["taken"], median=True)[0],
            "change_median_gap": compare.leaf_gap(
                program["change"], reference["change"], keep,
                median=True)[0]}


def judge(ctx, cfg, datas, labels, first: dict, fed: list) -> dict:
    """The decode's and the step's numbers of a run, on the first card."""
    import torch
    world = len(fed)
    ref_fed = reference_batches(cfg, datas, labels, world)
    found = compare.batch_gaps([b for f in fed for b in f],
                               [b for f in ref_fed for b in f])
    device = "cuda:0" if ctx.device == "cuda" else ctx.device
    reference = reference_readings(cfg, ctx.seed, global_batches(fed),
                                   device, world)
    found.update(gaps(first, reference))
    found["reference_losses"] = reference["losses"]
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return found


# -- the trace ---------------------------------------------------------------

def nccl_exposed_seconds(events: list) -> float:
    """Seconds of a Chrome trace's device time in which an NCCL kernel runs
    and no other kernel, copy or set does."""
    nccl, other = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace_lib.DEVICE_CATS:
            continue
        ts = float(e.get("ts", 0.0))
        span = (ts, ts + float(e.get("dur", 0.0)))
        is_nccl = (e.get("cat") == "kernel"
                   and "nccl" in str(e.get("name", "")).lower())
        (nccl if is_nccl else other).append(span)
    other = trace_lib._merge(other)
    exposed, j = 0.0, 0
    for s, e in trace_lib._merge(nccl):
        while j < len(other) and other[j][1] <= s:
            j += 1
        covered, k = 0.0, j
        while k < len(other) and other[k][0] < e:
            covered += min(e, other[k][1]) - max(s, other[k][0])
            k += 1
        exposed += (e - s) - covered
    return exposed * 1e-6


class MeshTracer(trace_lib.Tracer):
    """The benchmark's tracer, which also reads from the trace the seconds
    in which the exchange runs alone on the card (``nccl_exposed_s``)."""

    nccl_exposed_s = None

    @property
    def summary(self):
        if self._summary is None and self._done is not None:
            self._done.export_chrome_trace(self.path)
            self._done = None
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(self.path)
            self._summary = trace_lib.summarize(events, self._window)
            self.nccl_exposed_s = nccl_exposed_seconds(events)
        return self._summary


# -- a worker ----------------------------------------------------------------

def flat_state(model):
    """Every parameter and floating buffer of ``model``, as one float32
    vector in the module's order."""
    import torch
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in model.state_dict().values()
                      if t.is_floating_point()])


def replica_gap(flat, group=None) -> tuple[float, int]:
    """The largest difference of ``flat`` from rank 0's, and how many
    elements differ at all (a collective)."""
    import torch
    theirs = flat.clone()
    torch.distributed.broadcast(theirs, src=0, group=group)
    differ = int((flat != theirs).sum())
    gap = float((flat - theirs).abs().max()) if flat.numel() else 0.0
    # a NaN differs from itself: such a replica is infinitely far
    return (gap if gap == gap else float("inf")), differ


def worker_main(ctx_path: str) -> int:
    import torch
    from attentionalpoolingaction_torch import train as train_lib
    from attentionalpoolingaction_torch.parallel import multihost

    with open(ctx_path) as f:
        ctx = common.Context(**json.load(f))
    common.cache_env()
    dev = multihost.setup(device="cpu" if ctx.device == "cpu" else None)
    rank = multihost.process_index()
    cfg = mesh_config(ctx)
    params, stats = make_weights(cfg, ctx.seed, dev)
    init = {td.key(p): t.clone() for p, t in gen_weights.leaves(params)
            + gen_weights.leaves(stats)}
    variables = (gen_weights.to_numpy(params), gen_weights.to_numpy(stats))
    del params, stats
    sync = (torch.cuda.synchronize if dev.type == "cuda" else
            (lambda: None))
    stop = threading.Event()
    tracer = MeshTracer(ctx.tmpdir) if ctx.trace and rank == 0 else None
    # the window and the stop are rank 0's: the other ranks keep the
    # judged readings and train on until the stop reaches them
    hook = td.WindowHook(init=init, warm_steps=int(ctx.traffic["warm_steps"]),
                         seconds=ctx.seconds if rank == 0 else math.inf,
                         stop=stop, sync=sync, tracer=tracer,
                         trace=ctx.traffic.get("trace"))
    create, to_device = train_lib.create_state, train_lib.batch_to_device
    start = {}

    def created(*a, **kw):
        # step 0: every rank holds rank 0's bits
        state, spec = create(*a, variables=variables, **kw)
        start["gap"], start["differ"] = replica_gap(flat_state(state.model))
        return state, spec
    fed = []

    def tap(batch, device):
        # the first batches as the step gets them, copied to the host
        out = to_device(batch, device)
        if len(fed) < JUDGED_STEPS:
            fed.append((out["image"].detach().cpu().numpy(),
                        torch.as_tensor(out["label"]).cpu().numpy()))
        return out
    train_lib.create_state, train_lib.batch_to_device = created, tap
    try:
        state, _ = train_lib.train(cfg, hooks=[hook], device=dev,
                                   stop_event=stop)
    finally:
        train_lib.create_state, train_lib.batch_to_device = create, to_device
    del variables
    moved = sum(int((b.detach() != init[td.key(path)]).sum())
                for name, b in state.model.named_buffers()
                for coll, path in [gen_weights.port_name_to_path(name)]
                if coll == "batch_stats")
    gap, differ = replica_gap(flat_state(state.model))
    out = {"rank": rank, "init_mismatch": start["differ"],
           "replica_gap": gap, "replica_elements_differ": differ,
           "bn_stats_moved": moved,
           "nonfinite_params": sum(not bool(torch.isfinite(p).all())
                                   for p in state.model.parameters()),
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    np.savez(os.path.join(ctx.tmpdir, f"rank{rank}_batches.npz"),
             **{f"image{k}": b[0] for k, b in enumerate(fed)},
             **{f"label{k}": b[1] for k, b in enumerate(fed)})
    if rank == 0:
        if hook.window_end is None:
            raise RuntimeError("the run ended before its window closed")
        out.update(
            losses=hook.losses, taken=hook.taken, change=hook.change,
            window_start=hook.window_start, window_end=hook.window_end,
            steps=hook.steps,
            window_nonfinite=sum(not np.isfinite(float(x))
                                 for x in hook.window_losses))
        if tracer is not None:
            with open(os.path.join(ctx.tmpdir, "trace.pkl"), "wb") as f:
                pickle.dump(tracer.summary, f)
            out.update(nccl_exposed_s=tracer.nccl_exposed_s,
                       traced_steps=int(ctx.traffic["trace"]["steps"]),
                       span_totals=span_totals())
    with open(os.path.join(ctx.tmpdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def span_totals() -> dict | None:
    """The port's span totals of the traced steps, or None where the port
    keeps no spans."""
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals as totals)
    except ImportError:
        return None
    return totals()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="one rank of a train_mesh run")
    p.add_argument("--worker", required=True, help="the run's context.json")
    sys.exit(worker_main(p.parse_args().worker))
