"""Dataset descriptors for MPII, HICO, and HMDB51: an own copy of the JAX
package's ``data/datasets.py``.

The canonical class counts are MPII 393 action classes (single-label, 16
pose joints), HICO 600 human-object-interaction classes (multi-label),
HMDB51 51 classes (per-frame records grouped by video id).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    multi_label: bool                 # sigmoid-CE multi-hot vs softmax-CE
    has_pose: bool = False            # MPII pose keypoints present
    num_joints: int = 0
    is_video: bool = False            # HMDB per-frame records w/ video ids
    splits: Mapping[str, int | None] = dataclasses.field(
        default_factory=dict)         # split -> num_examples (None = unknown)
    eval_metric: str = "map"          # "map" | "accuracy"

    def labels_shape(self):
        return (self.num_classes,) if self.multi_label else ()


DATASETS: dict[str, DatasetSpec] = {
    "mpii": DatasetSpec(
        name="mpii", num_classes=393, multi_label=False,
        has_pose=True, num_joints=16,
        splits={"train": 15_205, "val": 6_987, "test": None},
        eval_metric="map",
    ),
    "hico": DatasetSpec(
        name="hico", num_classes=600, multi_label=True,
        splits={"train": 38_116, "test": 9_658},
        eval_metric="map",
    ),
    "hmdb51": DatasetSpec(
        name="hmdb51", num_classes=51, multi_label=False, is_video=True,
        splits={"train": None, "test": None},
        eval_metric="accuracy",
    ),
}


def get_dataset(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; available: {sorted(DATASETS)}"
        ) from None
