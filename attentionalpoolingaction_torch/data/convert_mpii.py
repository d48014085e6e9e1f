"""MPII raw data -> TFRecords: the dataset converter of the port, a copy of
the JAX package's ``data/convert_mpii.py`` without TensorFlow.

The MPII release annotation (``mpii_human_pose_v1_u12_1.mat``) stores,
per image, the activity id (``act.act_id``, 1..397 with gaps), the
train/test flag and per-person 16-joint keypoints
(``annolist.annorect.annopoints``).  :func:`parse_mpii_mat` flattens that
matlab object graph into plain dicts; :func:`write_records` writes the
schema of ``data/records.py``, each JPEG's height and width read from its
frame header (:func:`data.jpeg.frame_size`, as
``tf.io.extract_jpeg_shape`` reads them).

    python -m attentionalpoolingaction_torch.data.convert_mpii \\
        --mat mpii_human_pose_v1_u12_1.mat --images_dir images/ \\
        --out_dir records/ [--shards 32] [--val_fraction 0.315]
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os

import numpy as np

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import records as rec
from attentionalpoolingaction_torch.ops.heatmap import MPII_NUM_JOINTS

log = logging.getLogger(__name__)


def _field(obj, name, default=None):
    return getattr(obj, name, default)


def parse_mpii_mat(release) -> list[dict]:
    """Flatten the RELEASE struct that ``scipy.io.loadmat(...,
    squeeze_me=True, struct_as_record=False)`` gives into one dict per
    annotated image: ``image_name``, ``act_id``, ``is_train``,
    ``keypoints`` ((K, 2) (y, x), or None) and ``visibility``.  An image
    with several people takes the first annotated one (the single-frame
    action task is image-level)."""
    out = []
    annolist = np.atleast_1d(release.annolist)
    acts = np.atleast_1d(release.act)
    is_train = np.atleast_1d(release.img_train)
    for i, anno in enumerate(annolist):
        act_id = int(_field(acts[i], "act_id", -1) or -1)
        name = str(anno.image.name)
        kps = None
        vis = None
        rects = _field(anno, "annorect")
        if rects is not None:
            for rect in np.atleast_1d(rects):
                pts = _field(rect, "annopoints")
                if pts is None or isinstance(pts, np.ndarray) and not pts.size:
                    continue
                point = np.atleast_1d(_field(pts, "point"))
                kps = np.full((MPII_NUM_JOINTS, 2), -1.0, np.float32)
                vis = np.zeros((MPII_NUM_JOINTS,), np.float32)
                for pt in point:
                    j = int(pt.id)
                    if 0 <= j < MPII_NUM_JOINTS:
                        kps[j] = (float(pt.y), float(pt.x))
                        v = _field(pt, "is_visible", 1)
                        try:
                            vis[j] = float(v) if np.size(v) else 1.0
                        except (TypeError, ValueError):
                            vis[j] = 1.0
                break  # the first annotated person
        out.append({
            "image_name": name,
            "act_id": act_id,
            "is_train": bool(is_train[i]),
            "keypoints": kps,
            "visibility": vis,
        })
    return out


def assign_split(image_name: str, val_fraction: float) -> str:
    """``"val"`` or ``"train"``, from the md5 of the image name.  MPII's
    public release withholds the activity labels of its test images, so
    the val split is carved out of the labeled training images; hashing
    the name keeps the split the same across runs and machines."""
    h = int.from_bytes(
        hashlib.md5(image_name.encode()).digest()[:8], "little")
    return "val" if (h % 10_000) < int(val_fraction * 10_000) else "train"


def build_label_map(entries) -> dict[int, int]:
    """The sparse MPII act_ids that occur -> dense labels 0..C-1, in
    sorted order."""
    ids = sorted({e["act_id"] for e in entries if e["act_id"] >= 0})
    return {a: i for i, a in enumerate(ids)}


def write_records(entries, images_dir, out_dir, *, split, label_map,
                  shards=8, writer_cls=rec.ShardedTFRecordWriter) -> int:
    """Write one split's entries as sharded TFRecords; returns the number
    of examples.  Entries without an action label are skipped.  It
    streams: one image in memory at a time, each example written to its
    round-robin shard at once."""
    with writer_cls(out_dir, split, shards) as w:
        for e in entries:
            if e["act_id"] not in label_map:
                continue
            with open(os.path.join(images_dir, e["image_name"]), "rb") as f:
                data = f.read()
            height, width = jpeg.frame_size(data)
            kps = e["keypoints"]
            w.write(rec.make_example(
                data, height=height, width=width,
                label=label_map[e["act_id"]],
                keypoints=kps if kps is not None else np.full(
                    (MPII_NUM_JOINTS, 2), -1.0, np.float32),
                visibility=e["visibility"] if e["visibility"] is not None
                else np.zeros((MPII_NUM_JOINTS,), np.float32)))
        return w.count


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mat", required=True, help="mpii_human_pose .mat path")
    p.add_argument("--images_dir", required=True,
                   help="MPII images directory")
    p.add_argument("--out_dir", required=True,
                   help="output TFRecord directory")
    p.add_argument("--shards", type=int, default=32,
                   help="number of output shards per split")
    p.add_argument("--val_fraction", type=float, default=0.315,
                   help="fraction of labeled training images held out as "
                   "the val split (test labels are withheld upstream)")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, int]:
    """Convert the release: both splits from the labeled (``img_train``)
    images.  Returns the examples written a split."""
    args = parse_args(argv)
    import scipy.io

    mat = scipy.io.loadmat(args.mat, squeeze_me=True,
                           struct_as_record=False)
    entries = parse_mpii_mat(mat["RELEASE"])
    label_map = build_label_map(entries)
    log.info("%d images, %d action classes", len(entries), len(label_map))
    labeled = [e for e in entries if e["is_train"]]
    counts = {}
    for split in ("train", "val"):
        split_entries = [
            e for e in labeled
            if assign_split(e["image_name"], args.val_fraction) == split]
        counts[split] = write_records(
            split_entries, args.images_dir, args.out_dir, split=split,
            label_map=label_map, shards=args.shards)
        log.info("%s: wrote %d examples", split, counts[split])
    return counts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
