"""Batch inference CLI: the port of the JAX package's ``predict_cli.py``,
with argparse in place of absl and the same flags by name.  Checkpoint +
image files -> one JSON line of top-k classes an image, through
``serving.Predictor``: the same decode, crop, bucketing, softmax (or
sigmoid) and top-k as ``serve_cli``'s ``/predict``.

    python -m attentionalpoolingaction_torch.predict_cli \\
        --config mpii_rank1_224 --workdir /tmp/run1 \\
        --images a.jpg b.png [--topk 5] [--batch_size 32] [--int8] \\
        [--step best] [--ema] [--device cpu]
    # one video as its ordered frames -> one clip-pooled prediction:
    python -m attentionalpoolingaction_torch.predict_cli \\
        --config hmdb51_clip8 --workdir /tmp/run2 --video \\
        --images f000.jpg f001.jpg f002.jpg

    # from an exported artifact (export_cli.py) instead of a checkpoint:
    python -m attentionalpoolingaction_torch.predict_cli \\
        --exported_dir /tmp/run1/artifact --images a.jpg b.png

``--video`` with a single ``.mp4``/``.avi``/``.mov``/``.mkv``/``.webm``
path decodes that container with OpenCV, and exits with JAX's error
("bad video: ...") where OpenCV is not installed.  With
``--exported_dir`` the checkpoint-only flags (``--config``, ``--workdir``,
``--int8``, ``--ema``, ``--step``, ``--set``) are usage errors.
``--data_parallel`` splits each batch over the local cards (one replica
a card; one card: single-device dispatch); ``--device`` takes the place
of ``--jax_platform``.
"""

from __future__ import annotations

import argparse
import json

from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.serve_cli import config_from_args
from attentionalpoolingaction_torch.train_cli import add_bool_flag

VIDEO_SUFFIXES = ("mp4", "avi", "mov", "mkv", "webm", "video")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the checkpoint-only flags default to None, which tells a flag given
    # from one left out (export.reject_checkpoint_flags)
    p.add_argument("--config", help="preset name (default mpii_rank1_224)")
    p.add_argument("--workdir", help="run dir containing checkpoints/")
    p.add_argument("--exported_dir",
                   help="predict from an exported artifact (export_cli.py)")
    p.add_argument("--images", nargs="+", action="extend", default=[],
                   help="input image paths (repeatable)")
    add_bool_flag(p, "video", False,
                  "treat --images as the ordered frames of one video (or, "
                  "for one video file, the container itself) and print one "
                  "clip-pooled prediction")
    p.add_argument("--topk", type=int, default=5,
                   help="top-k classes to report")
    p.add_argument("--batch_size", type=int, default=32,
                   help="inference batch size")
    p.add_argument("--step", help="checkpoint step: an int, or 'best' for "
                   "the keep-best slot (default latest)")
    add_bool_flag(p, "int8", None,
                  "BN-folded post-training int8 path (models/inference.py)")
    add_bool_flag(p, "ema", None,
                  "use the EMA weights (requires ema_decay training)")
    add_bool_flag(p, "data_parallel", False,
                  "shard each batch across all local devices")
    p.add_argument("--set", action="append",
                   help="config override field=value; repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to predict on (default cuda)")
    return p.parse_args(argv)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.exported_dir:
        from attentionalpoolingaction_torch import export as export_lib

        export_lib.reject_checkpoint_flags(
            args, ("config", "workdir", "int8", "ema", "step", "set"))
        predictor = export_lib.load_exported(
            args.exported_dir, data_parallel=args.data_parallel,
            device=args.device)
    elif args.workdir:
        predictor = serving.load_predictor(
            config_from_args(args), step=args.step, int8=bool(args.int8),
            buckets=(args.batch_size,), use_ema=bool(args.ema),
            data_parallel=args.data_parallel, device=args.device)
    else:
        raise SystemExit("one of --workdir / --exported_dir is required")
    paths = list(args.images)
    if args.video:
        blobs = [_read(p) for p in paths]
        if len(paths) == 1 and \
                paths[0].rsplit(".", 1)[-1].lower() in VIDEO_SUFFIXES:
            res = predictor.predict_video_bytes(blobs[0], topk=args.topk)
        else:
            res = predictor.predict_clip_bytes(blobs, topk=args.topk)
        if "error" in res:
            raise SystemExit(res["error"])
        print(json.dumps({"frames": paths, **res}), flush=True)
        return
    for lo in range(0, len(paths), args.batch_size):
        chunk = paths[lo:lo + args.batch_size]
        results = predictor.predict_bytes([_read(p) for p in chunk],
                                          topk=args.topk)
        for path, res in zip(chunk, results):
            print(json.dumps({"image": path, **res}), flush=True)


if __name__ == "__main__":
    main()
