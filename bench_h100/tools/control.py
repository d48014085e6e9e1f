"""The control of each cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
(bfloat16 convs and activations where the configuration states float32
with TF32 convs), judged by the same numbers against the float32
reference, at the cell's own sizes, on the card.

    python3 bench_h100/tools/control.py --workload <name> --seeds 1 2 3

Prints one JSON line a seed with the numbers compared and the cell's
limits; each seed's control has to fail at least one of them.  For the
training cell it also reads the faults planted in the reference put in
the program's place (half of each batch left out, the loss 2% high, the
decoded images with red and blue swapped).
"""

from __future__ import annotations

import argparse
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
from bench_h100.cell import port_config  # noqa: E402


def serve_control(ctx: common.Context) -> dict:
    """The bfloat16 reference's top-k answers of the sample of pool images
    a run would judge, against the float32 reference's logits."""
    import torch
    from bench_h100.drivers import serve_http as sh
    from bench_h100.generators import images as gen_images
    from bench_h100.reference import compare
    tr = ctx.traffic
    cfg = port_config(ctx)
    pool = gen_images.make_pool(ctx.seed, tr["mix"], int(tr["pool_images"]),
                                int(tr["jpeg_quality"]))
    k = int(tr["check"]["sample"])
    picks = np.random.default_rng([ctx.seed, 6]).integers(0, len(pool), k)
    datas = [pool[int(j)]["data"] for j in picks]
    crops = sh.reference_crops(cfg, datas)
    ref = sh.reference_logits(cfg, ctx.seed, crops, ctx.device)
    low = sh.reference_logits(cfg, ctx.seed, crops, ctx.device,
                              dtype=torch.bfloat16)
    topk = int(tr["server"]["topk"])
    answers = []
    for row in low:
        e = np.exp(row - row.max())
        p = (e / e.sum()).astype(np.float32)
        top = np.argsort(-p)[:topk]
        answers.append([{"class": int(c), "prob": float(p[c])} for c in top])
    out = compare.served_gaps(answers, ref)
    # in units of the bfloat16 reference's own gap, as a run judges
    out.update(compare.bf16_ratio(answers, ref, low))
    # the decode stage's fault: the crops with red and blue swapped
    out["crop_pixel_gap_rb_swapped"] = compare.batch_gaps(
        [(crops[..., ::-1], [])], [(crops, [])])["batch_pixel_gap"]
    return out


def train_control(ctx: common.Context) -> dict:
    import dataclasses
    import os

    import torch
    from bench_h100.drivers import train as td
    from bench_h100.reference import compare
    cfg = port_config(ctx)
    path = os.path.join(ctx.tmpdir, "train.tfrecord")
    cfg = dataclasses.replace(cfg, seed=ctx.seed, train_pattern=path)
    datas, labels = td.write_records(ctx, cfg, path)
    batches = td.reference_batches(cfg, datas, labels)
    ref = td.reference_readings(cfg, ctx.seed, batches, ctx.device)
    low = td.reference_readings(cfg, ctx.seed, batches, ctx.device,
                                dtype=torch.bfloat16)
    out = td.gaps(low, ref)
    # faults planted in the reference put in the program's place: half of
    # each batch left out (the mean over the rest), the loss 2% high
    half = td.reference_readings(
        cfg, ctx.seed, [(i[:len(i) // 2], lb[:len(lb) // 2])
                        for i, lb in batches], ctx.device)
    out.update({f"half_batch.{k}": v for k, v in td.gaps(half, ref).items()})
    scaled = dict(ref, losses=[1.02 * x for x in ref["losses"]])
    out["loss_scaled.first_loss_gap"] = td.gaps(scaled, ref)[
        "first_loss_gap"]
    # the decode stage's fault: the batches with red and blue swapped
    swapped = [(imgs[..., ::-1], labs) for imgs, labs in batches]
    out["batch_pixel_gap_rb_swapped"] = compare.batch_gaps(
        swapped, batches)["batch_pixel_gap"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    common.cache_env()
    for seed in a.seeds:
        with tempfile.TemporaryDirectory(prefix="bench_h100_") as d:
            ctx = bench_run.make_context(argparse.Namespace(
                workload=a.workload, seed=seed, seconds=0, trace=0),
                tmpdir=d)
            fn = (serve_control if ctx.traffic["driver"] == "serve_http"
                  else train_control)
            found = fn(ctx)
        limits = ctx.traffic["check"]["limits"]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": found, "limits": limits,
                          "fails": any(found[k] > v
                                       for k, v in limits.items()
                                       if k in found)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
