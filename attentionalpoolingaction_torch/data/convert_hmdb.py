"""HMDB51 videos -> per-frame TFRecords: the dataset converter of the
port, a copy of the JAX package's ``data/convert_hmdb.py`` without
TensorFlow.

It reads the standard HMDB51 layout (class-named directories of ``.avi``
files, and the testTrainMulti split files
``<class>_test_split<k>.txt`` with the flags 1 = train, 2 = test, 0 =
unused), samples up to ``--frames_per_video`` frames of each video
uniformly with OpenCV, encodes them as JPEGs and writes per-frame
examples tagged with a video id (eval averages the per-frame logits of a
video).  OpenCV is needed to read the videos and, by default, to encode
the frames (``IMWRITE_JPEG_QUALITY`` = ``quality``); where it is missing
the import fails as the JAX package's does.  The JAX package encodes with
``tf.io.encode_jpeg``: :func:`write_records` takes the encoder as an
argument, and given that one writes the same bytes.

    python -m attentionalpoolingaction_torch.data.convert_hmdb \\
        --videos_dir hmdb51/ --splits_dir testTrainMulti_7030_splits/ \\
        --out_dir records/ [--split_id 1] [--frames_per_video 25] \\
        [--shards 32]
"""

from __future__ import annotations

import argparse
import functools
import glob
import logging
import os
from typing import Callable

import numpy as np

from attentionalpoolingaction_torch.data import records as rec

log = logging.getLogger(__name__)


def read_split_files(splits_dir: str, split_id: int):
    """``({video_rel_path: "train" | "test"}, [class names])``."""
    assignment = {}
    classes = []
    pattern = os.path.join(splits_dir, f"*_test_split{split_id}.txt")
    for path in sorted(glob.glob(pattern)):
        cls = os.path.basename(path).rsplit(
            f"_test_split{split_id}.txt", 1)[0]
        classes.append(cls)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                name, flag = parts[0], parts[1]
                if flag == "1":
                    assignment[f"{cls}/{name}"] = "train"
                elif flag == "2":
                    assignment[f"{cls}/{name}"] = "test"
    return assignment, classes


def sample_frame_indices(num_frames: int, num_samples: int) -> np.ndarray:
    """Uniformly spaced frame indices (deterministic; the input pipeline
    jitters at train time)."""
    if num_frames <= 0:
        return np.zeros((0,), np.int64)
    n = min(num_samples, num_frames)
    return np.linspace(0, num_frames - 1, n).round().astype(np.int64)


def extract_frames(video_path: str, num_samples: int) -> list[np.ndarray]:
    """Up to ``num_samples`` uniformly sampled frames of a video as RGB
    uint8 arrays, read by OpenCV."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    idxs = set(sample_frame_indices(total, num_samples).tolist())
    frames = []
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i in idxs:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    return frames


def write_records(video_items, out_dir, *, split, frames_per_video=25,
                  shards=8, quality=90,
                  writer_cls=rec.ShardedTFRecordWriter,
                  encode_jpeg: Callable[[np.ndarray], bytes] | None = None
                  ) -> int:
    """``video_items``: an iterable of ``(video_id, label, video_path)``.
    Returns the number of frame examples written.

    It streams: at most one video's decoded frames are in memory, and
    each example goes to its shard file as soon as it is encoded.  All
    frames of video ``vid`` land in shard ``vid`` (mod the shards).
    ``encode_jpeg(rgb_frame) -> bytes`` encodes a frame; by default
    OpenCV at ``quality``."""
    if encode_jpeg is None:
        encode_jpeg = functools.partial(rec._cv2_encode_jpeg,
                                        quality=quality)
    with writer_cls(out_dir, split, shards) as w:
        for vid, (video_id, label, path) in enumerate(video_items):
            frames = extract_frames(path, frames_per_video)
            for fi, frame in enumerate(frames):
                w.write(rec.make_example(
                    encode_jpeg(frame), height=frame.shape[0],
                    width=frame.shape[1], label=label, video_id=video_id,
                    frame=fi), shard=vid)
        return w.count


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--videos_dir", required=True,
                   help="HMDB51 root of class directories")
    p.add_argument("--splits_dir", required=True,
                   help="testTrainMulti split files directory")
    p.add_argument("--out_dir", required=True,
                   help="output TFRecord directory")
    p.add_argument("--split_id", type=int, default=1,
                   help="HMDB split number (1-3)")
    p.add_argument("--frames_per_video", type=int, default=25,
                   help="sampled frames per video")
    p.add_argument("--shards", type=int, default=32, help="shards per split")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, int]:
    """Convert both splits; returns the frame examples written a split."""
    args = parse_args(argv)
    assignment, classes = read_split_files(args.splits_dir, args.split_id)
    label_map = {c: i for i, c in enumerate(sorted(classes))}
    counts = {}
    for split in ("train", "test"):
        items = []
        for rel, s in sorted(assignment.items()):
            if s != split:
                continue
            cls = rel.split("/", 1)[0]
            items.append((len(items), label_map[cls],
                          os.path.join(args.videos_dir, rel)))
        counts[split] = write_records(
            items, args.out_dir, split=split,
            frames_per_video=args.frames_per_video, shards=args.shards)
        log.info("%s: %d videos -> %d frame examples", split, len(items),
                 counts[split])
    return counts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
