"""Training CLI: the port of the JAX package's ``train_cli.py`` (the
reference's ``python train.py --flags`` surface), with argparse in place
of absl and the same flags by name.

    python -m attentionalpoolingaction_torch.train_cli \\
        --config mpii_rank1_224 \\
        --train_pattern=/data/mpii/train-*.tfrecord \\
        --workdir=/tmp/run1 [--set batch_size=64 --set learning_rate=0.01] \\
        [--eval_pattern=/data/mpii/val-*.tfrecord --eval_every 1000] \\
        [--device cpu]

It trains on ``--device`` (default ``cuda``) from the records of
``--train_pattern``, TFRecord or ArrayRecord (JPEG decode on the device), checkpoints to
``<workdir>/checkpoints`` and resumes from there, writes the train and
eval scalars as TensorBoard event files into the workdir, and with
``--eval_every`` evaluates ``--eval_pattern`` and keeps the best step in
``<workdir>/checkpoints_best``.  ``--attn_summary_every N`` writes
attention-map overlays of a fixed probe batch (``utils/visualize.py``) as
image summaries into the event file every N steps.  ``--device`` takes the
place of ``--jax_platform``.

``--multiprocess`` joins a job of one process a card
(``parallel.multihost.setup``: NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device cpu``), from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    torchrun --nproc_per_node 4 -m attentionalpoolingaction_torch.train_cli \
        --multiprocess --config mpii_rank5_450_mesh --set mesh_shape='(4,)' \
        --train_pattern=... --workdir=...

Each process trains on its share of the global batch over the mesh of
``mesh_shape``; only process 0 writes the event files.
"""

from __future__ import annotations

import argparse
import logging

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import train as train_lib
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.utils import metrics_writer

log = logging.getLogger(__name__)


def add_bool_flag(parser, name: str, default: bool, help: str) -> None:
    """``--name`` / ``--noname``, as absl spells a boolean flag."""
    parser.add_argument(f"--{name}", dest=name, action="store_true",
                        default=default, help=help)
    parser.add_argument(f"--no{name}", dest=name, action="store_false",
                        help=argparse.SUPPRESS)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mpii_rank1_224",
                   help=f"preset name, one of {sorted(config_lib.PRESETS)}")
    p.add_argument("--train_pattern", help="train record glob: TFRecord, "
                   "or ArrayRecord (*.array_record)")
    p.add_argument("--eval_pattern", help="eval record glob: TFRecord, "
                   "or ArrayRecord (*.array_record)")
    p.add_argument("--workdir", help="checkpoint/metrics dir")
    p.add_argument("--init_checkpoint",
                   help="fine-tune init: a TF-slim checkpoint (e.g. "
                   "ImageNet resnet_v1_101.ckpt) or a checkpoint directory "
                   "of an earlier run of the port; the heads stay fresh")
    p.add_argument("--num_steps", type=int, help="override number of steps")
    p.add_argument("--eval_every", type=int, default=0,
                   help="evaluate --eval_pattern every N steps (0 = off)")
    add_bool_flag(p, "keep_best", True,
                  "with --eval_every: keep the best step in "
                  "<workdir>/checkpoints_best (restore with --step best)")
    p.add_argument("--set", action="append", default=[],
                   help="config override field=value (a python literal "
                   "when it parses as one); repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default cuda)")
    add_bool_flag(p, "multiprocess", False,
                  "join a multi-process job (torchrun's environment): one "
                  "process a card")
    p.add_argument("--attn_summary_every", type=int, default=0,
                   help="attention-map overlay images in the event file "
                   "every N steps (0 = off)")
    p.add_argument("--trace_at_step", type=int, default=0,
                   help="capture a torch.profiler trace from this step "
                   "(0 = off) into <workdir>/trace")
    p.add_argument("--trace_steps", type=int, default=3,
                   help="steps per trace")
    return p.parse_args(argv)


def main(argv=None):
    """Train as the flags say; returns the final train state."""
    args = parse_args(argv)
    device = None
    if args.multiprocess:
        device = multihost.setup(device=args.device)
    overrides = config_lib.parse_overrides(args.set)
    for key in ("train_pattern", "eval_pattern", "workdir",
                "init_checkpoint"):
        val = getattr(args, key)
        if val is not None:
            overrides[key] = val
    cfg = config_lib.get_config(args.config, **overrides)
    device = device or resolve_device(args.device)
    log.info("config: %s", cfg)

    mgr = ckpt_lib.make_manager(cfg.workdir + "/checkpoints",
                                max_to_keep=cfg.max_checkpoints)
    writer = metrics_writer.make_writer(
        cfg.workdir, just_logging=multihost.process_index() != 0)
    hooks = [metrics_writer.make_train_hook(writer, cfg.log_every)]
    if args.eval_every and cfg.eval_pattern:
        from attentionalpoolingaction_torch import evaluate as eval_lib

        # one Evaluator for the run: its model is built once
        evaluator = eval_lib.Evaluator(cfg, device=device)
        best_keeper = (ckpt_lib.BestKeeper(cfg.workdir)
                       if args.keep_best else None)

        def eval_hook(step, state, metrics):
            del metrics
            if step % args.eval_every == 0:
                results = evaluator(state)
                metrics_writer.write_eval(writer, step, results)
                log.info("eval@%d: %s", step, results)
                if best_keeper is not None:
                    best_keeper.update(step, results, state)

        hooks.append(eval_hook)
    else:
        best_keeper = None
    if args.attn_summary_every:
        from attentionalpoolingaction_torch.utils import visualize

        hooks.append(visualize.make_attention_summary_hook(
            cfg, writer, args.attn_summary_every, device=device))
    if args.trace_at_step:
        from attentionalpoolingaction_torch.utils import profiling

        hooks.append(profiling.make_trace_hook(
            cfg.workdir + "/trace", args.trace_at_step, args.trace_steps,
            last_step=args.num_steps or cfg.num_steps))
    try:
        state, _ = train_lib.train(
            cfg, num_steps=args.num_steps, checkpoint_manager=mgr,
            hooks=hooks, device=device)
    finally:
        # a save still in flight commits, or raises, before the CLI ends
        mgr.wait_until_finished()
        if best_keeper is not None:
            best_keeper.wait_until_finished()
        writer.close()
    log.info("done at step %d", state.step)
    return state


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
