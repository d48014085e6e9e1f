"""Record-container converter, TFRecord <-> ArrayRecord: the port of the
JAX package's ``data/reformat.py``, with argparse in place of absl.

ArrayRecord's footer is its index, so the pipeline's global shuffle needs
no ``.idx`` sidecar.  Convert a dataset with

    python -m attentionalpoolingaction_torch.data.reformat \\
        --src '/data/mpii/train-*.tfrecord' --dst_dir /data/mpii_ar

The direction comes from each file's extension: ``*.tfrecord`` (or any
other) goes to ``*.array_record``, ``*.array_record`` and
``*.arrayrecord`` go to ``*.tfrecord``.  Only the container changes: the
payload stays serialized ``tf.train.Example`` bytes, so a TFRecord ->
ArrayRecord -> TFRecord round trip gives the original file byte for byte.
Either package's converter reads the other's ArrayRecord files.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.array_record import ArrayRecordFile

__all__ = ["main", "reformat_file"]

log = logging.getLogger(__name__)

_AR_EXTS = (".array_record", ".arrayrecord")


def _read_array_record(path):
    src = ArrayRecordFile(path)
    try:
        for i in range(len(src)):
            yield src[i]
    finally:
        src.close()


def reformat_file(src_path: str, dst_dir: str) -> str:
    """Convert one file into ``dst_dir``; returns the path written."""
    base, ext = os.path.splitext(os.path.basename(src_path))
    if ext in _AR_EXTS:
        dst = os.path.join(dst_dir, base + ".tfrecord")
        records.write_tfrecord(dst, _read_array_record(src_path))
    else:
        dst = os.path.join(dst_dir, base + ".array_record")
        records.write_array_record(dst, records.read_tfrecord(src_path))
    return dst


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True, help="source file glob")
    p.add_argument("--dst_dir", required=True, help="output directory")
    args = p.parse_args(argv)
    paths = sorted(glob.glob(args.src))
    if not paths:
        raise SystemExit(f"no files match {args.src}")
    os.makedirs(args.dst_dir, exist_ok=True)
    for path in paths:
        dst = reformat_file(path, args.dst_dir)
        log.info("%s -> %s", path, dst)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
