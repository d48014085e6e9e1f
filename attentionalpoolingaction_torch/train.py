"""The model-building part of the JAX package's ``train.py``:
``feature_size``, ``normalize_images`` and ``build_model``.  The loss,
optimizer and train loop are a later port."""

from __future__ import annotations

import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.data.preprocessing import (
    B_MEAN,
    G_MEAN,
    R_MEAN,
)
from attentionalpoolingaction_torch.models.factory import get_model
from attentionalpoolingaction_torch.models.resnet import feature_size

__all__ = ["build_model", "feature_size", "normalize_images"]


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """Device-side VGG mean subtraction for uint8 batches (4x less
    host-to-device traffic than f32); float inputs pass through (already
    normalized on the host)."""
    if images.dtype.is_floating_point:
        return images
    mean = torch.tensor([R_MEAN, G_MEAN, B_MEAN], dtype=torch.float32,
                        device=images.device)
    return images.to(torch.float32) - mean


def build_model(cfg: config_lib.TrainConfig, device=None):
    """The config's ActionModel in eval mode on ``device`` (default
    ``cuda``).  The backbone runs in float32, which is what the
    ``mpii_rank1_224`` preset asks for; ``bf16_backbone`` is not ported
    yet and raises."""
    if cfg.bf16_backbone:
        raise NotImplementedError(
            "bf16_backbone is not ported yet; set bf16_backbone=False")
    spec = get_dataset(cfg.dataset)
    return get_model(
        cfg.backbone, num_classes=spec.num_classes, pooling=cfg.pooling,
        rank=cfg.rank, num_joints=spec.num_joints,
        bn_momentum=cfg.bn_momentum, image_size=cfg.image_size,
        device=device)
