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

``--video`` with a single ``.mp4``/``.avi``/``.mov``/``.mkv``/``.webm``
path decodes that container with OpenCV, and exits with JAX's error
("bad video: ...") where OpenCV is not installed.  ``--exported_dir`` and
``--data_parallel`` are not ported yet and raise
``NotImplementedError``; ``--device`` takes the place of
``--jax_platform``.
"""

from __future__ import annotations

import argparse
import json

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.serve_cli import unported_flags
from attentionalpoolingaction_torch.train_cli import add_bool_flag

VIDEO_SUFFIXES = ("mp4", "avi", "mov", "mkv", "webm", "video")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mpii_rank1_224", help="preset name")
    p.add_argument("--workdir", help="run dir containing checkpoints/")
    p.add_argument("--exported_dir",
                   help="predict from an exported artifact (not ported yet)")
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
    add_bool_flag(p, "int8", False,
                  "BN-folded post-training int8 path (models/inference.py)")
    add_bool_flag(p, "ema", False,
                  "use the EMA weights (requires ema_decay training)")
    add_bool_flag(p, "data_parallel", False,
                  "shard each batch across all local devices (not ported "
                  "yet)")
    p.add_argument("--set", action="append", default=[],
                   help="config override field=value; repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to predict on (default cuda)")
    return p.parse_args(argv)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def main(argv=None) -> None:
    args = parse_args(argv)
    unported_flags(args)
    if not args.workdir:
        raise SystemExit("--workdir is required")
    overrides = config_lib.parse_overrides(args.set)
    overrides["workdir"] = args.workdir
    cfg = config_lib.get_config(args.config, **overrides)
    predictor = serving.load_predictor(
        cfg, step=args.step, int8=args.int8, buckets=(args.batch_size,),
        use_ema=args.ema, device=args.device)
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
