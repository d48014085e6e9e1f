"""Model zoo of the port: slim-variant ResNet-v1 backbones, pooling heads,
ActionModel and the factory."""

from attentionalpoolingaction_torch.models.resnet import (
    ResNetV1,
    resnet_v1_50,
    resnet_v1_101,
    resnet_v1_152,
)
from attentionalpoolingaction_torch.models.heads import (
    AttentionalPoolingHead,
    AveragePoolingHead,
    PoseHead,
)
from attentionalpoolingaction_torch.models.action_model import ActionModel
from attentionalpoolingaction_torch.models.factory import get_model

__all__ = [
    "ResNetV1",
    "resnet_v1_50",
    "resnet_v1_101",
    "resnet_v1_152",
    "AttentionalPoolingHead",
    "AveragePoolingHead",
    "PoseHead",
    "ActionModel",
    "get_model",
]
