"""Evaluation CLI: the port of the JAX package's ``eval_cli.py`` (the
reference's ``python eval.py --flags`` surface), with argparse in place of
absl and the same flags by name.

    python -m attentionalpoolingaction_torch.eval_cli \\
        --config mpii_rank1_224 --eval_pattern=/data/mpii/val-*.tfrecord \\
        --workdir=/tmp/run1 [--step 20000 | --step best] \\
        [--follow --poll_secs 60] [--device cpu]

It restores a step of ``<workdir>/checkpoints`` (the latest by default,
``best`` for the keep-best slot), evaluates the records (TFRecord or
ArrayRecord) of ``--eval_pattern`` on ``--device`` (default ``cuda``) and prints the
results as one JSON line, with the JAX CLI's keys (the metrics and
``step``).  ``--follow`` evaluates each new step as it appears; ``--tb``
(on by default; ``--notb``) writes the ``eval/*`` scalars as TensorBoard
event files into the workdir; ``--per_class_output`` appends the
per-class AP.

``--multiprocess`` joins a job of one process a card (as ``train_cli``'s
does): each process evaluates its shard of the split and the results are
gathered, the processes agree on process 0's step (``--follow`` too), and
only process 0 prints and writes.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import evaluate as eval_lib
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.train_cli import add_bool_flag
from attentionalpoolingaction_torch.utils import metrics_writer

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mpii_rank1_224", help="preset name")
    p.add_argument("--eval_pattern", help="eval record glob: TFRecord, "
                   "or ArrayRecord (*.array_record)")
    p.add_argument("--workdir", help="run dir containing checkpoints/")
    p.add_argument("--step", help="checkpoint step: an int, or 'best' for "
                   "the keep-best slot (default: latest)")
    p.add_argument("--set", action="append", default=[],
                   help="config override field=value; repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to evaluate on (default cuda)")
    add_bool_flag(p, "multiprocess", False,
                  "join a multi-process job (torchrun's environment): each "
                  "process evaluates 1/process_count of the split, results "
                  "are gathered")
    add_bool_flag(p, "follow", False,
                  "keep polling for new checkpoints and evaluate each one")
    p.add_argument("--poll_secs", type=float, default=60,
                   help="poll interval for --follow")
    p.add_argument("--max_evals", type=int,
                   help="stop --follow after this many evaluations")
    p.add_argument("--out_json", help="also append results as JSON lines "
                   "to this file")
    add_bool_flag(p, "per_class", False, "include per-class AP in results")
    add_bool_flag(p, "tb", True, "write eval/* scalars as TensorBoard event "
                  "files to the workdir")
    p.add_argument("--per_class_output",
                   help="append {step, per_class_ap[, per_class_ap_ko]} "
                   "JSON lines to this file")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Evaluate as the flags say; returns the results printed."""
    args = parse_args(argv)
    device = None
    if args.multiprocess:
        device = multihost.setup(device=args.device)
    if args.follow and args.step is not None:
        raise SystemExit(
            "--follow re-evaluates each NEW checkpoint; --step (incl. "
            "'best') is a one-shot selection: drop one of the two")
    overrides = config_lib.parse_overrides(args.set)
    if args.eval_pattern:
        overrides["eval_pattern"] = args.eval_pattern
    if args.workdir:
        overrides["workdir"] = args.workdir
    cfg = config_lib.get_config(args.config, **overrides)
    device = device or resolve_device(args.device)

    mgr, step_flag = ckpt_lib.manager_for_step(cfg.workdir, args.step)
    evaluator = eval_lib.Evaluator(cfg, device=device)   # built once
    # every process holds the same gathered results; process 0 emits them
    first = multihost.process_index() == 0
    writer = (metrics_writer.make_writer(cfg.workdir)
              if args.tb and first else None)
    want_per_class = args.per_class or bool(args.per_class_output)
    printed = []

    def eval_step(step):
        restored = ckpt_lib.restore_for_eval(mgr, step=step)
        # if any process failed to restore (a step pruned in between),
        # every process skips: the others would wait in the gather
        if multihost.allreduce_flag(restored is None):
            return None
        results = evaluator(restored, return_per_class=want_per_class)
        results["step"] = int(restored.step)
        log.info("eval results: %s", results)
        if not first:
            printed.append(results)
            return results
        if writer is not None:
            metrics_writer.write_eval(writer, results["step"], results)
            writer.flush()
        if args.per_class_output:
            pc = {"step": results["step"]}
            for k in ("per_class_ap", "per_class_ap_ko"):
                if k in results:
                    pc[k] = results[k]
            with open(args.per_class_output, "a") as f:
                f.write(json.dumps(pc) + "\n")
        if not args.per_class:
            # the vectors were only computed for --per_class_output
            results = {k: v for k, v in results.items()
                       if not k.startswith("per_class_ap")}
        print(json.dumps(results), flush=True)
        if args.out_json:
            with open(args.out_json, "a") as f:
                f.write(json.dumps(results) + "\n")
        printed.append(results)
        return results

    try:
        if not args.follow:
            step = (step_flag if step_flag is not None
                    else multihost.broadcast_step(mgr.latest_step()))
            if step is None or eval_step(step) is None:
                raise SystemExit(f"no checkpoint found under {mgr.directory}")
            return printed
        seen = set()
        while args.max_evals is None or len(seen) < args.max_evals:
            mgr.reload()
            latest = multihost.broadcast_step(mgr.latest_step())
            if latest is not None and latest not in seen:
                seen.add(latest)
                eval_step(latest)
            else:
                time.sleep(args.poll_secs)
        return printed
    finally:
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
