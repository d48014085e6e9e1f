"""Pooling heads: average pooling (baseline), attentional pooling (the
paper's contribution) and the auxiliary pose head.  Port of the JAX
package's ``models/heads.py``.  Every head takes NHWC features (B, h, w, F).
"""

from __future__ import annotations

import torch
from torch import nn

from attentionalpoolingaction_torch.ops import attn_pool as ap_ops
from attentionalpoolingaction_torch.ops import attn_pool_cuda


class AveragePoolingHead(nn.Module):
    """Global average pool + dense logits (slim's standard resnet tail)."""

    def __init__(self, num_features: int, num_classes: int):
        super().__init__()
        self.logits = nn.Linear(num_features, num_classes)

    def forward(self, feats):
        return self.logits(feats.to(torch.float32).mean(dim=(1, 2)))


class AttentionalPoolingHead(nn.Module):
    """Rank-P second-order attentional pooling.

    The parameters keep the JAX layouts: ``attn_w (F, C, P)``,
    ``attn_b (C, P)``, ``sal_w (F, P)``, ``sal_b (P,)``.  On a CUDA tensor
    the logits come from the hand-written kernels
    (``ops/attn_pool_cuda.py``), whatever ``use_pallas`` said in the JAX
    config; on a CPU tensor from their plain versions.

    The init stddev is (n*f)^-1/2 per branch, as in the JAX head, so that
    random-init logits start O(var(x)); ``num_positions`` is n.
    """

    def __init__(self, num_features: int, num_classes: int, rank: int = 1,
                 num_positions: int = 49):
        super().__init__()
        std = float(num_positions * num_features) ** -0.5
        self.attn_w = nn.Parameter(
            self._trunc((num_features, num_classes, rank), std))
        self.attn_b = nn.Parameter(torch.zeros(num_classes, rank))
        self.sal_w = nn.Parameter(self._trunc((num_features, rank), std))
        self.sal_b = nn.Parameter(torch.zeros(rank))
        self._w_pfc_key = None
        self._w_pfc = None

    @staticmethod
    def _trunc(shape, std):
        t = torch.empty(shape)
        return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)

    def w_pfc(self):
        """The kernel's (P, F, C) copy of ``attn_w``, remade only when
        ``attn_w`` changes (a load bumps its version counter)."""
        w = self.attn_w
        key = (w.data_ptr(), w._version, w.device)
        if key != self._w_pfc_key:
            with torch.no_grad():
                self._w_pfc = attn_pool_cuda.attn_w_pfc(w)
            self._w_pfc_key = key
        return self._w_pfc

    def forward(self, feats, return_maps: bool = False):
        b, h, w, f = feats.shape
        x = feats.reshape(b, h * w, f)
        params = (self.attn_w, self.attn_b, self.sal_w, self.sal_b)
        # the cached copy carries no gradient: the CPU path (which may
        # train) makes its own
        w_pfc = self.w_pfc() if x.is_cuda else None
        logits = attn_pool_cuda.attentional_pool_fused(
            x.contiguous(), *params, w_pfc=w_pfc)
        if return_maps:
            top, bot = ap_ops.attention_maps(x, *params)
            return logits, (top.reshape(b, h, w, -1), bot.reshape(b, h, w))
        return logits


class PoseHead(nn.Module):
    """Auxiliary pose head: 1x1 conv f -> num_joints (+1 background channel)
    predicting heatmaps at feature resolution, NHWC out."""

    def __init__(self, num_features: int, num_joints: int = 16,
                 with_background: bool = True):
        super().__init__()
        out_ch = num_joints + (1 if with_background else 0)
        self.pose_conv = nn.Conv2d(num_features, out_ch, 1)

    def forward(self, feats):
        x = feats.to(torch.float32).permute(0, 3, 1, 2)
        return self.pose_conv(x).permute(0, 2, 3, 1)
