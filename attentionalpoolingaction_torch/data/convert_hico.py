"""HICO raw data -> TFRecords: the dataset converter of the port, a copy of
the JAX package's ``data/convert_hico.py`` without TensorFlow.

HICO's ``anno.mat`` carries ``list_train``/``list_test`` (file names) and
``anno_train``/``anno_test`` (600 x N matrices: +1 positive, -1
negative, 0 or NaN unknown).  The multi-hot target takes unknown as
negative (the default protocol); the raw {+1, -1, 0} vector is stored too
(``image/class/anno``), for the "Known Object" protocol of eval.  Each
JPEG's height and width come from its frame header
(:func:`data.jpeg.frame_size`).

    python -m attentionalpoolingaction_torch.data.convert_hico \\
        --mat anno.mat --images_dir hico/images --out_dir records/ \\
        [--shards 32]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import records as rec

log = logging.getLogger(__name__)

NUM_HOI_CLASSES = 600


def anno_to_multi_hot(anno_col: np.ndarray) -> np.ndarray:
    """(600,) of {+1, -1, 0, NaN} -> multi-hot {0, 1} int64."""
    col = np.nan_to_num(np.asarray(anno_col, np.float32), nan=0.0)
    return (col > 0).astype(np.int64)


def anno_to_known(anno_col: np.ndarray) -> np.ndarray:
    """(600,) of {+1, -1, 0, NaN} -> {+1, -1, 0} int64 (NaN is
    unknown)."""
    col = np.nan_to_num(np.asarray(anno_col, np.float32), nan=0.0)
    return np.sign(col).astype(np.int64)


def write_records(filenames, anno, images_dir, out_dir, *, split,
                  shards=8, writer_cls=rec.ShardedTFRecordWriter) -> int:
    """Write one split as sharded TFRecords; returns the number of
    examples.  It streams: one image in memory at a time, each example
    written to its round-robin shard at once."""
    with writer_cls(out_dir, split, shards) as w:
        for i, name in enumerate(filenames):
            with open(os.path.join(images_dir, str(name)), "rb") as f:
                data = f.read()
            height, width = jpeg.frame_size(data)
            w.write(rec.make_example(
                data, height=height, width=width,
                multi_hot=anno_to_multi_hot(anno[:, i]),
                anno=anno_to_known(anno[:, i])))
        return w.count


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mat", required=True, help="HICO anno.mat path")
    p.add_argument("--images_dir", required=True,
                   help="HICO images root (train2015/, test2015/)")
    p.add_argument("--out_dir", required=True,
                   help="output TFRecord directory")
    p.add_argument("--shards", type=int, default=32, help="shards per split")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, int]:
    """Convert both splits; returns the examples written a split."""
    args = parse_args(argv)
    import scipy.io

    mat = scipy.io.loadmat(args.mat, squeeze_me=True)
    counts = {}
    for split, list_key, anno_key, subdir in (
            ("train", "list_train", "anno_train", "train2015"),
            ("test", "list_test", "anno_test", "test2015")):
        filenames = np.atleast_1d(mat[list_key])
        anno = np.asarray(mat[anno_key])
        if anno.shape[0] != NUM_HOI_CLASSES:    # the JAX package asserts
            raise ValueError(f"{anno_key} has shape {anno.shape}; HICO "
                             f"has {NUM_HOI_CLASSES} classes a column")
        counts[split] = write_records(
            filenames, anno, os.path.join(args.images_dir, subdir),
            args.out_dir, split=split, shards=args.shards)
        log.info("%s: wrote %d examples", split, counts[split])
    return counts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
