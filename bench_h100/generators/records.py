"""Seeded MPII-schema training records.

Record ``i`` holds JPEG ``pool[i % len(pool)]`` with a label, 16
keypoints and their visibility drawn from a numpy generator keyed on
``seed``, as the port's own synthetic writer draws them.  The records are
framed by the port's TFRecord writer and indexed by its indexer: that is
the file format the system under test reads.  The reference never reads
them: it takes the same pool and the returned labels from memory.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 16


def draw_labels(seed: int, n: int, num_classes: int) -> dict:
    rng = np.random.default_rng([seed, 5])
    return {"label": rng.integers(0, num_classes, n).astype(np.int64),
            "keypoints": rng.uniform(size=(n, NUM_JOINTS, 2)),
            "visibility": (rng.uniform(size=(n, NUM_JOINTS)) > 0.2)}


def write(path: str, pool: list[dict], n: int, seed: int,
          num_classes: int) -> dict:
    """``n`` records at ``path`` (indexed beside it); returns the drawn
    labels, keypoints and visibility and the pool index of each record."""
    from attentionalpoolingaction_torch.data import native_io, records

    drawn = draw_labels(seed, n, num_classes)
    which = np.arange(n) % len(pool)

    def examples():
        for i in range(n):
            img = pool[int(which[i])]
            h, w = img["height"], img["width"]
            yield records.make_example(
                img["data"], height=h, width=w,
                label=int(drawn["label"][i]),
                keypoints=(drawn["keypoints"][i] * [h, w]).astype(
                    np.float32),
                visibility=drawn["visibility"][i].astype(np.float32))

    records.write_tfrecord(path, examples())
    if native_io.build_index(path) != n:
        raise RuntimeError(f"{path} does not hold {n} records")
    drawn["pool_index"] = which
    return drawn
