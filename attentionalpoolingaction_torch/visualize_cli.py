"""Attention-map visualization CLI: restore a checkpoint, run images, and
write heatmap-overlay PNGs (the top-down attention of a class and the
bottom-up saliency).  Port of the JAX package's ``visualize_cli.py``, with
argparse in place of absl and the same flags by name.

    python -m attentionalpoolingaction_torch.visualize_cli \\
        --config mpii_rank1_224 --workdir /tmp/run1 \\
        --images img1.jpg img2.png --out_dir /tmp/viz [--class_idx 42] \\
        [--step best] [--device cpu]
    # the ordered frames of one video: per-frame overlays and the temporal
    # attention (which frames drove the prediction)
    python -m attentionalpoolingaction_torch.visualize_cli \\
        --config hmdb51_clip8 --workdir /tmp/run2 --clip \\
        --images f000.jpg f001.jpg ... --out_dir /tmp/viz

An image is read through the port's byte path on ``--device`` (default
``cuda``): a JPEG by nvJPEG on a card (OpenCV on the CPU), a PNG by
``data/png.py``; it is cropped as the JAX package's ``load_and_preprocess``
crops it (the short side to ``round(S * 256 / 224)``, the central S x S,
mean-subtracted float32), whatever ``resize_min`` the config says.  The
overlays are written by ``data/png.py``: ``<stem>_top_down.png`` and
``<stem>_saliency.png`` an image (``<stem>_t<k>_...`` with ``--clip``).
``--device`` takes the place of ``--jax_platform``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.convert import load_flax_variables
from attentionalpoolingaction_torch.data import png
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.train import build_model
from attentionalpoolingaction_torch.train_cli import add_bool_flag
from attentionalpoolingaction_torch.utils import visualize as viz

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mpii_rank1_224", help="preset name")
    p.add_argument("--workdir", required=True,
                   help="run dir containing checkpoints/")
    p.add_argument("--images", nargs="+", action="extend", default=[],
                   help="input image paths, JPEG or PNG (repeatable)")
    p.add_argument("--out_dir", default="/tmp/attnpool_viz",
                   help="output directory")
    p.add_argument("--class_idx", type=int, default=None,
                   help="class to visualize (default: the predicted "
                   "arg-max)")
    p.add_argument("--step", help="checkpoint step: an int, or 'best' for "
                   "the keep-best slot (default latest)")
    add_bool_flag(p, "clip", False,
                  "treat --images as the ORDERED frames of one video: run "
                  "the clip-level spatiotemporal forward and write "
                  "per-frame overlays plus the temporal attention")
    p.add_argument("--set", action="append", default=[],
                   help="config override field=value; repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default cuda)")
    return p.parse_args(argv)


def load_and_preprocess(path: str, image_size: int, device
                        ) -> torch.Tensor:
    """The mean-subtracted float32 (S, S, 3) eval crop of an image file on
    ``device``, at the JAX CLI's geometry: the short side to
    ``round(S * 256 / 224)``, the central S x S."""
    with open(path, "rb") as f:
        decoded = serving.decode_image(f.read(), device)
    h, w = decoded.shape[:2]
    g = pp.draw_geometry(h, w, out_size=image_size, is_training=False,
                         resize_min=round(image_size * 256 / 224))
    return pp.apply_geometry(decoded, g, out_size=image_size,
                             keep_uint8=False)


def _write(path: str, image) -> None:
    with open(path, "wb") as f:
        f.write(png.encode(image))


def main(argv=None) -> dict:
    """Write the overlays; returns the overlay dict of
    ``utils/visualize.py`` with the written ``paths``."""
    args = parse_args(argv)
    if not args.images:
        raise SystemExit("--images is required")
    overrides = config_lib.parse_overrides(args.set)
    overrides["workdir"] = args.workdir
    cfg = config_lib.get_config(args.config, **overrides)
    device = resolve_device(args.device)
    mgr, step = ckpt_lib.manager_for_step(cfg.workdir, args.step)
    restored = ckpt_lib.restore_for_eval(mgr, step=step)
    if restored is None:
        raise SystemExit(f"no checkpoint under {mgr.directory}")
    model = load_flax_variables(build_model(cfg, device=device),
                                restored.params, restored.batch_stats)
    images = torch.stack([load_and_preprocess(p, cfg.image_size, device)
                          for p in args.images])

    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    stems = [os.path.splitext(os.path.basename(p))[0] for p in args.images]
    if args.clip:
        out = viz.clip_attention_overlays(model, images,
                                          class_idx=args.class_idx)
        for t, stem in enumerate(stems):
            for kind in ("top_down", "saliency"):
                paths.append(os.path.join(args.out_dir,
                                          f"{stem}_t{t:03d}_{kind}.png"))
                _write(paths[-1], out[kind][t])
        ta = ", ".join(f"t{t}={v:.3f}"
                       for t, v in enumerate(out["temporal_attention"]))
        print(f"predicted class {out['class_idx']}; temporal attention: "
              f"{ta}")
    else:
        out = viz.attention_overlays(model, images,
                                     class_idx=args.class_idx)
        for i, stem in enumerate(stems):
            for kind in ("top_down", "saliency"):
                paths.append(os.path.join(args.out_dir,
                                          f"{stem}_{kind}.png"))
                _write(paths[-1], out[kind][i])
            log.info("%s: predicted class %d, wrote overlays",
                     args.images[i], int(out["class_idx"][i]))
    print(f"wrote {len(paths)} overlays to {args.out_dir}", flush=True)
    return {**out, "paths": paths}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
