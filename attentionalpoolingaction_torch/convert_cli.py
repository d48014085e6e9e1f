"""Checkpoint conversion CLI: a TF1-slim ResNet checkpoint -> report,
merge onto the port's backbone, and an optional parity check.  Port of
the JAX package's ``convert_cli.py``, with argparse in place of absl and
the same flags by name.

    python -m attentionalpoolingaction_torch.convert_cli \\
        --slim_checkpoint /path/resnet_v1_101.ckpt \\
        --backbone resnet_v1_101 [--parity_check] [--device cpu]

Training reads slim checkpoints directly (``--init_checkpoint``; the
conversion happens in ``train.create_state``).  This tool reads one with
the port's plain-Python reader (``tf_checkpoint.py``, no TensorFlow),
converts it (``checkpoint.convert_slim_checkpoint``), merges it onto a
fresh backbone (``checkpoint.merge_pretrained``, which raises on a shape
mismatch or a variable the model lacks) and, with ``--parity_check``,
runs the merged backbone on two random 224 px images on ``--device``
(default ``cuda``) and checks that the feature map is finite.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch.convert import (
    load_flax_variables,
    state_dict_to_flax,
)
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models.resnet import BACKBONES
from attentionalpoolingaction_torch.train_cli import add_bool_flag

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--slim_checkpoint", required=True,
                   help="path of a TF1-slim checkpoint (V2 prefix or V1 "
                   "file)")
    p.add_argument("--backbone", default="resnet_v1_101",
                   help="model scope / backbone name")
    add_bool_flag(p, "parity_check", False,
                  "run the merged backbone on random inputs")
    p.add_argument("--device", default=None,
                   help="torch device of the parity check (default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Convert, merge and check as the flags say; returns the counts (and
    the feature map's shape and moments with ``--parity_check``)."""
    args = parse_args(argv)
    converted = ckpt_lib.convert_slim_checkpoint(
        args.slim_checkpoint, model_scope=args.backbone)
    report = {"params": len(ckpt_lib._flatten(converted["params"])),
              "batch_stats": len(ckpt_lib._flatten(
                  converted["batch_stats"]))}
    print(f"converted {report['params']} params + {report['batch_stats']} "
          "batch_stats", flush=True)

    # the backbone under "resnet", the name the weight bridge maps
    model = torch.nn.ModuleDict({"resnet": BACKBONES[args.backbone](
        generator=torch.Generator().manual_seed(0))})
    params, stats = state_dict_to_flax(model.state_dict())
    merged = ckpt_lib.merge_pretrained(
        {"params": params, "batch_stats": stats}, converted)
    load_flax_variables(model, merged["params"], merged["batch_stats"])
    print(f"merge onto {args.backbone} OK", flush=True)

    if args.parity_check:
        device = resolve_device(args.device)
        backbone = model["resnet"].to(device).eval()
        x = torch.randn((2, 3, 224, 224),
                        generator=torch.Generator().manual_seed(1)).to(device)
        with torch.no_grad():
            feats = backbone(x, global_pool=False).float().cpu().numpy()
        report.update(feature_shape=list(feats.shape),
                      feature_mean=float(feats.mean()),
                      feature_std=float(feats.std()))
        print(f"feature map {feats.shape}, mean {feats.mean():.4f} std "
              f"{feats.std():.4f}", flush=True)
        if not np.isfinite(feats).all():
            raise SystemExit("parity check failed: non-finite features")
        print("PARITY-READY: converted backbone runs; compare logits "
              "against the reference run to close the bit-faithful gate",
              flush=True)
    return report


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
