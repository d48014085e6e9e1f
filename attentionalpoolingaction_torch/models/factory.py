"""Model factory: name -> ActionModel.  Port of the JAX package's
``models/factory.py``."""

from __future__ import annotations

import torch

from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models.action_model import ActionModel
from attentionalpoolingaction_torch.models.resnet import BACKBONES


def get_model(backbone: str = "resnet_v1_101", *, num_classes: int,
              pooling: str = "attention", rank: int = 1,
              num_joints: int = 16, bn_momentum: float = 0.997,
              image_size: int = 224, freeze_bn: bool = False,
              generator: torch.Generator | None = None,
              dtype: torch.dtype = torch.float32,
              remat_units: bool = False, device=None) -> ActionModel:
    """An ActionModel in eval mode on ``device`` (default ``cuda``; raises
    when there is no card and the caller did not ask for the CPU), its
    weights drawn from ``generator`` as Flax draws them, its backbone
    computing in ``dtype`` (parameters float32), each bottleneck
    rematerialized in the backward with ``remat_units``.  ``train()``
    switches it to the training forward."""
    if backbone not in BACKBONES:
        raise ValueError(
            f"unknown backbone {backbone!r}; available: {sorted(BACKBONES)}")
    with torch.device(resolve_device(device)):
        model = ActionModel(
            num_classes=num_classes,
            backbone=backbone,
            pooling=pooling,
            rank=rank,
            num_joints=num_joints,
            bn_momentum=bn_momentum,
            image_size=image_size,
            freeze_bn=freeze_bn,
            generator=generator,
            dtype=dtype,
            remat_units=remat_units,
        )
    return model.eval()
