"""ActionModel: backbone + selected pooling head (+ optional pose head).
Port of the JAX package's ``models/action_model.py``.

images (NHWC) -> ResNet-v1 features -> {avg | attention | pose-attention}
head -> ``out`` dict with ``logits`` (+ ``pose_heatmaps``, ``features``,
and with ``return_maps`` ``attn_maps`` / ``saliency``), all NHWC.

``model.train()`` is the JAX package's ``train=True``: batch norm
normalizes with batch statistics and updates its running ones.  With
``freeze_bn`` the batch norms stay in eval mode whatever ``train()`` says
(the slim fine-tuning recipe); gradients still reach their scale and
offset.

``dtype`` is the backbone's compute dtype (bfloat16 with the config's
``bf16_backbone``); the parameters are float32 whatever it is, and the
features are cast to float32 before every head, so the heads, the pose
heatmaps and the logits are float32.  ``remat_units`` rematerializes
each bottleneck of the backbone in the backward (``models/resnet.py``);
the heads are outside the rematerialized units.
"""

from __future__ import annotations

import torch
from torch import nn

from attentionalpoolingaction_torch.models.heads import (
    AttentionalPoolingHead,
    AveragePoolingHead,
    PoseHead,
)
from attentionalpoolingaction_torch.models.resnet import (
    BACKBONES,
    BatchNorm,
    feature_size,
)

POOLING_TYPES = ("avg", "attention", "pose_attention")
NUM_FEATURES = 2048


class ActionModel(nn.Module):
    def __init__(self, num_classes: int, backbone: str = "resnet_v1_101",
                 pooling: str = "attention", rank: int = 1,
                 num_joints: int = 16, bn_momentum: float = 0.997,
                 image_size: int = 224, freeze_bn: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 remat_units: bool = False):
        super().__init__()
        if pooling not in POOLING_TYPES:
            raise ValueError(f"unknown pooling {pooling!r}")
        self.pooling = pooling
        self.freeze_bn = freeze_bn
        self.resnet = BACKBONES[backbone](bn_momentum=bn_momentum,
                                          generator=generator, dtype=dtype,
                                          remat_units=remat_units)
        if pooling == "avg":
            self.head = AveragePoolingHead(NUM_FEATURES, num_classes,
                                           generator=generator)
        else:
            self.head = AttentionalPoolingHead(
                NUM_FEATURES, num_classes, rank=rank,
                num_positions=feature_size(image_size) ** 2,
                generator=generator)
        if pooling == "pose_attention":
            self.pose_head = PoseHead(NUM_FEATURES, num_joints,
                                      generator=generator)

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_bn:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.eval()
        return self

    def forward(self, images, return_maps: bool = False):
        # Video clips: a 5-D (B, T, H, W, C) batch runs the backbone per
        # frame and the pooling spans all T*h*w positions (T folds into the
        # feature-map height; the heads are position-count-agnostic).
        clip_t = None
        if images.ndim == 5:
            if self.pooling == "pose_attention":
                raise ValueError(
                    "pose_attention pooling is per-image (pose targets "
                    "have no temporal dim) — use pooling='attention' or "
                    "'avg' for video clips")
            b, clip_t = images.shape[:2]
            images = images.reshape((b * clip_t,) + images.shape[2:])
        feats = self.resnet(images.permute(0, 3, 1, 2), global_pool=False)
        feats = feats.permute(0, 2, 3, 1).to(torch.float32)   # NHWC
        if clip_t is not None:
            bt, fh, fw, ff = feats.shape
            feats = feats.reshape(bt // clip_t, clip_t * fh, fw, ff)

        out = {}
        if self.pooling == "avg":
            out["logits"] = self.head(feats)
        elif return_maps:
            out["logits"], (top, bot) = self.head(feats, return_maps=True)
            if clip_t is not None:
                # per-frame maps: (B, T, h, w, ...)
                top = top.reshape((top.shape[0], clip_t, -1) + top.shape[2:])
                bot = bot.reshape(bot.shape[0], clip_t, -1, bot.shape[2])
            out["attn_maps"], out["saliency"] = top, bot
        else:
            out["logits"] = self.head(feats)

        if self.pooling == "pose_attention":
            out["pose_heatmaps"] = self.pose_head(feats)
        out["features"] = feats
        return out
