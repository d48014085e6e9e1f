"""The control of the data-parallel cell's comparison: the frozen-BN plain
reference put in the program's place and computed one precision below
the configuration's bfloat16 (each conv's inputs and weights rounded to
float8 e4m3 with a per-tensor scale, the rest float32), judged by the
same numbers against the float32 reference, at the cell's own sizes, on
one card.

    python3 bench_h100/tools/control_mesh.py --seeds 1 2 3

Prints one JSON line a seed: the numbers compared, the cell's limits,
whether the control fails at least one of them, and the same for three
faults planted in the reference put in the program's place: ranks that
skip the gradients' all-reduce and each step on their own gradient
(rank 0's readings, and the replicas' gap), half of each rank's batch
left out (the mean over the rest), and the decoded images with red and
blue swapped.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from bench_h100 import common  # noqa: E402
from bench_h100 import run as bench_run  # noqa: E402

WORKLOAD = "mpii450_mesh4_train"
# the largest finite float8 e4m3 value
E4M3_MAX = 448.0


def float8(t):
    """``t`` rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude to E4M3_MAX) and back; the gradient passes straight
    through."""
    import torch
    scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


@contextlib.contextmanager
def float8_convs():
    """Every conv of the plain reference on float8-rounded inputs and
    weights, for the duration."""
    from bench_h100.reference import model as ref_model
    conv = ref_model._conv
    ref_model._conv = lambda x, kernel, stride: conv(
        float8(x), float8(kernel), stride)
    try:
        yield
    finally:
        ref_model._conv = conv


def unreduced_readings(cfg, seed: int, batches: list, device,
                       world: int) -> dict:
    """The fault of ranks that skip the gradients' all-reduce: each rank's
    reference steps on the gradient of its own rows alone (its share of
    the global batch's loss, as the port divides by the global count),
    the losses are still summed over the ranks.  Rank 0's readings, and
    ``replica_gap``, the largest difference of a rank's parameters from
    rank 0's after the steps."""
    import torch
    from bench_h100.cell import make_weights
    from bench_h100.drivers import train as td
    from bench_h100.reference import compare
    from bench_h100.reference import model as ref_model
    from bench_h100.reference.train_frozen import FrozenTrainer
    trainers = [FrozenTrainer(*make_weights(cfg, seed, device),
                              td.recipe(cfg)) for _ in range(world)]
    init = {p: t.clone() for p, t in trainers[0].params.items()}
    out = {"losses": []}
    with ref_model.exact_float32():
        for k, (imgs, labs) in enumerate(batches):
            rows = len(labs)
            size = rows // world
            total = 0.0
            for r, trainer in enumerate(trainers):
                part = slice(r * size, (r + 1) * size)
                loss, grads = trainer.block_loss_and_grads(
                    torch.as_tensor(np.asarray(imgs[part])).to(device),
                    torch.as_tensor(np.asarray(labs[part], np.int64)).to(
                        device), rows)
                taken, _ = trainer.apply(grads, {})
                total += float(loss)
                if k == 0 and r == 0:
                    out["taken"] = compare.norms(
                        {td.key(p): t for p, t in taken.items()})
            out["losses"].append(total)
    lead = trainers[0].params
    out["change"] = compare.norms(
        {td.key(p): lead[p] - init[p] for p in init})
    out["replica_gap"] = max(
        float((t.params[p] - lead[p]).abs().max())
        for t in trainers[1:] for p in lead) if world > 1 else 0.0
    return out


def mesh_control(ctx: common.Context) -> dict:
    import torch
    from bench_h100.drivers import train as td
    from bench_h100.drivers import train_mesh as tm
    from bench_h100.reference import compare
    cfg = tm.mesh_config(ctx)
    world = tm.world_of(cfg)
    datas, labels = td.write_records(ctx, cfg, cfg.train_pattern)
    per_rank = tm.reference_batches(cfg, datas, labels, world)
    batches = tm.global_batches(per_rank)
    ref = tm.reference_readings(cfg, ctx.seed, batches, ctx.device, world)
    with float8_convs():
        low = tm.reference_readings(cfg, ctx.seed, batches, ctx.device,
                                    world)
    out = {"control": tm.gaps(low, ref)}
    half = tm.global_batches(
        [[(i[:len(i) // 2], lb[:len(lb) // 2]) for i, lb in f]
         for f in per_rank])
    out["half_batch"] = tm.gaps(
        tm.reference_readings(cfg, ctx.seed, half, ctx.device, world), ref)
    lone = unreduced_readings(cfg, ctx.seed, batches, ctx.device, world)
    out["no_all_reduce"] = dict(tm.gaps(lone, ref),
                                replica_gap=lone["replica_gap"])
    swapped = [(imgs[..., ::-1], labs) for imgs, labs in batches]
    out["rb_swapped"] = compare.batch_gaps(swapped, batches)
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return out


def fails(found: dict, limits: dict) -> bool:
    return any(found[k] > v for k, v in limits.items() if k in found)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--workload", default=WORKLOAD)
    a = p.parse_args(argv)
    common.cache_env()
    for seed in a.seeds:
        with tempfile.TemporaryDirectory(prefix="bench_h100_") as d:
            ctx = bench_run.make_context(argparse.Namespace(
                workload=a.workload, seed=seed, seconds=0, trace=0),
                tmpdir=d)
            found = mesh_control(ctx)
        limits = ctx.traffic["check"]["limits"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **found, "limits": limits,
                          "fails": {k: fails(v, limits)
                                    for k, v in found.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
