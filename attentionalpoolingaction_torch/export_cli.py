"""Export a checkpoint to a serving artifact (``torch.export`` programs):
the port of the JAX package's ``export_cli.py``, with argparse in place of
absl and the same flags by name.

    python -m attentionalpoolingaction_torch.export_cli \\
        --config mpii_rank1_224 --workdir /tmp/run1 \\
        --out_dir /tmp/run1/artifact [--int8 [--calibration_images a.jpg]] \\
        [--step best] [--ema] [--input_dtypes uint8,float32] [--device cpu]

The artifact then serves with no model code or checkpoint:

    python -m attentionalpoolingaction_torch.serve_cli \\
        --exported_dir /tmp/run1/artifact --port 8800

``--device`` (default ``cuda``) is the device the live predictor runs and
the programs are traced on; it takes the place of ``--platforms`` (also
accepted), since a program traced on either device serves on both.  After
writing, the artifact is loaded back on the same device and every exported
program (each input dtype, and the clip programs where exported) is held
against the live predictor on seeded random inputs: the largest
|Δprobability| is printed, and above 1e-6 the run exits non-zero.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import export as export_lib
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.train_cli import add_bool_flag

log = logging.getLogger(__name__)

PARITY_LIMIT = 1e-6


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="mpii_rank1_224", help="preset name")
    p.add_argument("--workdir", required=True,
                   help="run dir containing checkpoints/")
    p.add_argument("--out_dir", required=True, help="artifact directory")
    add_bool_flag(p, "int8", False, "export the quantized BN-folded path")
    add_bool_flag(p, "ema", False,
                  "export the EMA weights (requires ema_decay training)")
    p.add_argument("--step", help="checkpoint step: an int, or 'best' for "
                   "the keep-best slot (default latest)")
    p.add_argument("--buckets", default="1,8,32",
                   help="comma-separated batch-size buckets")
    p.add_argument("--input_dtypes", default="uint8,float32",
                   help="comma-separated input dtypes to export (one "
                   "program each)")
    p.add_argument("--calibration_images", action="append", default=[],
                   help="representative image for static int8 activation "
                   "scales; repeatable")
    p.add_argument("--set", action="append", default=[],
                   help="config override field=value; repeatable")
    p.add_argument("--device", "--platforms", dest="device", default=None,
                   help="torch device to trace on (default cuda)")
    return p.parse_args(argv)


def parity(loaded: export_lib.ExportedPredictor,
           live: serving.BucketedPredictor, seed: int = 0) -> dict:
    """max |Δprobability| between ``loaded`` and ``live`` for every program
    of the artifact, on seeded random inputs: 3 images an input dtype (raw
    RGB for uint8, mean-subtracted for float32), then the first alone at
    a batch of 1, and one clip of each dtype where the artifact has clip
    programs."""
    manifest = loaded.manifest
    rng = np.random.default_rng(seed)
    size = loaded.cfg.image_size
    out = {}

    def inputs(name, shape):
        raw = rng.integers(0, 255, shape)
        if name == "uint8":
            return raw.astype(np.uint8)
        # float programs take mean-subtracted images (serving's contract)
        return (raw.astype(np.float32) - 115.0).astype(name)

    for name in manifest["input_dtypes"]:
        imgs = inputs(name, (3, size, size, 3))
        out[name] = float(np.abs(loaded.predict_arrays(imgs)
                                 - live.predict_arrays(imgs)).max())
        one = loaded._probs(loaded._fwd(loaded._weights, imgs[:1]))
        out[f"{name} batch 1"] = float(np.abs(
            one - live._probs(live._fwd(live._weights, imgs[:1]))).max())
    if manifest.get("clip_frames"):
        t = manifest["clip_frames"]
        for name in manifest["input_dtypes"]:
            clip = inputs(name, (1, t, size, size, 3))
            a = loaded._probs(loaded._fwd(loaded._weights, clip))
            b = live._probs(live._fwd(live._weights, clip))
            out[f"clip T={t} {name}"] = float(np.abs(a - b).max())
    return out


def main(argv=None) -> dict:
    """Export, load back and gate; returns the manifest with the timings,
    sizes and parity values under ``"export_cli"``."""
    args = parse_args(argv)
    overrides = config_lib.parse_overrides(args.set)
    overrides["workdir"] = args.workdir
    cfg = config_lib.get_config(args.config, **overrides)
    predictor = serving.load_predictor(
        cfg, step=args.step, int8=args.int8,
        buckets=[int(b) for b in args.buckets.split(",")],
        calibration_files=args.calibration_images, use_ema=args.ema,
        device=args.device)
    t0 = time.perf_counter()
    manifest = export_lib.export_predictor(
        predictor, args.out_dir,
        input_dtypes=[np.dtype(n) for n in args.input_dtypes.split(",")])
    export_s = time.perf_counter() - t0
    files = os.listdir(args.out_dir)
    total = sum(os.path.getsize(os.path.join(args.out_dir, f))
                for f in files)
    weights = export_lib.weight_bytes(manifest)
    print(f"wrote {args.out_dir} ({len(files)} files, {total / 1e6:.1f} MB; "
          f"weights {weights / 1e6:.1f} MB) in {export_s:.1f} s: dtypes="
          f"{manifest['input_dtypes']} clip_frames="
          f"{manifest['clip_frames']} traced on {manifest['platforms']}",
          flush=True)

    # the load-back gate, on the device the live predictor runs on
    t0 = time.perf_counter()
    loaded = export_lib.load_exported(args.out_dir, device=predictor.device)
    load_s = time.perf_counter() - t0
    diffs = parity(loaded, predictor)
    for name, diff in diffs.items():
        print(f"EXPORT PARITY[{name}] max|dprob| = {diff:.3g}", flush=True)
    worst = max(diffs.values())
    if worst > PARITY_LIMIT:
        raise SystemExit(f"export parity failed: {worst} > {PARITY_LIMIT}")
    manifest["export_cli"] = {"export_seconds": export_s,
                              "load_seconds": load_s, "artifact_bytes": total,
                              "weight_bytes": weights, "parity": diffs}
    return manifest


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
