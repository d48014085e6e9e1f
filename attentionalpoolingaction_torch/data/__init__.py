"""Data layer of the port: dataset descriptors and the VGG means."""

from attentionalpoolingaction_torch.data.datasets import (
    DATASETS,
    DatasetSpec,
    get_dataset,
)

__all__ = ["DATASETS", "DatasetSpec", "get_dataset"]
