"""Pooling heads: average pooling (baseline), attentional pooling (the
paper's contribution) and the auxiliary pose head.  Port of the JAX
package's ``models/heads.py``.  Every head takes NHWC features (B, h, w, F).
Each draws its weights from ``generator`` as Flax does: dense and conv
kernels ``lecun_normal``, biases zero.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from attentionalpoolingaction_torch.models.resnet import (
    lecun_normal_,
    truncated_normal,
)
from attentionalpoolingaction_torch.ops import attn_pool as ap_ops
from attentionalpoolingaction_torch.ops import attn_pool_cuda
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib


class AveragePoolingHead(nn.Module):
    """Global average pool + dense logits (slim's standard resnet tail)."""

    def __init__(self, num_features: int, num_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.logits = nn.Linear(num_features, num_classes)
        lecun_normal_(self.logits.weight, generator)
        nn.init.zeros_(self.logits.bias)

    class_group = None

    def shard_classes(self, group, index: int, count: int) -> None:
        """Keep classes ``index`` of ``count`` even shards (tensor
        parallelism over the mesh's model axis, the group ``group``): the
        logits of the other shards are all-gathered in the forward."""
        self.logits.weight = nn.Parameter(_shard(self.logits.weight, 0,
                                                 index, count))
        self.logits.bias = nn.Parameter(_shard(self.logits.bias, 0,
                                               index, count))
        self.class_group = group

    def forward(self, feats):
        pooled = feats.to(torch.float32).mean(dim=(1, 2))
        if self.class_group is None:
            return self.logits(pooled)
        # each rank's gradient of the pooled features covers its classes
        pooled = mesh_lib.reduce_grad(pooled, self.class_group)
        return mesh_lib.gather_classes(self.logits(pooled), self.class_group)


def _shard(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % count:
        raise ValueError(f"{n} classes do not split evenly into {count}")
    return t.detach().narrow(dim, index * (n // count), n // count).clone()


class AttentionalPoolingHead(nn.Module):
    """Rank-P second-order attentional pooling.

    The parameters keep the JAX layouts: ``attn_w (F, C, P)``,
    ``attn_b (C, P)``, ``sal_w (F, P)``, ``sal_b (P,)``.  The logits come
    from ``AttentionalPoolFn`` (``ops/attn_pool_cuda.py``): on a CUDA
    tensor the hand-written kernels, whatever ``use_pallas`` said in the
    JAX config, on a CPU tensor their plain versions; the backward is the
    JAX package's ``_fused_bwd`` in torch ops on both.

    The init stddev is (n*f)^-1/2 per branch, as in the JAX head, so that
    random-init logits start O(var(x)); ``num_positions`` is n.

    :meth:`shard_classes` keeps one shard of the classes (``attn_w[:,
    shard, :]``, ``attn_b[shard]``) for tensor parallelism over the
    mesh's model axis: ``project_logits`` runs on the shard, the logits
    are all-gathered over the model group, and ``AttentionalPoolFn``'s
    backward sums the shards' gradients of ``v`` and ``s`` over the group
    before its pass over X, so that the gradients of X and of ``sal_w``,
    ``sal_b`` are whole.  ``saliency_summary`` stays replicated: ``s`` and
    ``v`` are class-free.
    """

    class_group = None

    def __init__(self, num_features: int, num_classes: int, rank: int = 1,
                 num_positions: int = 49,
                 generator: torch.Generator | None = None):
        super().__init__()
        std = float(num_positions * num_features) ** -0.5

        def trunc(*shape):
            return nn.Parameter(truncated_normal(shape, std, generator).to(
                torch.get_default_device()))

        self.attn_w = trunc(num_features, num_classes, rank)
        self.attn_b = nn.Parameter(torch.zeros(num_classes, rank))
        self.sal_w = trunc(num_features, rank)
        self.sal_b = nn.Parameter(torch.zeros(rank))
        self._w_pfc_key = None
        self._w_pfc = None
        self._w_pfc_given = None

    def shard_classes(self, group, index: int, count: int) -> None:
        """Keep classes ``index`` of ``count`` even shards over the model
        group ``group`` (see the class docstring)."""
        self.attn_w = nn.Parameter(_shard(self.attn_w, 1, index, count))
        self.attn_b = nn.Parameter(_shard(self.attn_b, 0, index, count))
        self._w_pfc_key = None
        self.class_group = group

    def w_pfc(self):
        """The kernel's (P, F, C) copy of ``attn_w``, remade only when
        ``attn_w`` changes: a load or an optimizer step bumps its version
        counter, so training remakes it once a step."""
        if self._w_pfc_given is not None:
            return self._w_pfc_given
        w = self.attn_w
        key = (w.data_ptr(), w._version, w.device)
        if key != self._w_pfc_key:
            with torch.no_grad():
                self._w_pfc = attn_pool_cuda.attn_w_pfc(w)
            self._w_pfc_key = key
        return self._w_pfc

    @contextlib.contextmanager
    def given_w_pfc(self, w_pfc):
        """Forwards inside take ``w_pfc`` as the copy of ``attn_w``: an
        exported program (``export.py``) passes it in with the weights,
        where a traced ``attn_w`` has no storage to key a cache on."""
        self._w_pfc_given = w_pfc
        try:
            yield
        finally:
            self._w_pfc_given = None

    def forward(self, feats, return_maps: bool = False):
        b, h, w, f = feats.shape
        x = feats.reshape(b, h * w, f)
        params = (self.attn_w, self.attn_b, self.sal_w, self.sal_b)
        # the cached copy takes no gradient: AttentionalPoolFn's backward
        # gives attn_w its own
        logits = attn_pool_cuda.attentional_pool_fused(
            x.contiguous(), *params, w_pfc=self.w_pfc(),
            class_group=self.class_group)
        if self.class_group is not None:
            logits = mesh_lib.gather_classes(logits, self.class_group)
        if return_maps:
            top, bot = ap_ops.attention_maps(x, *params)
            return logits, (top.reshape(b, h, w, -1), bot.reshape(b, h, w))
        return logits


class PoseHead(nn.Module):
    """Auxiliary pose head: 1x1 conv f -> num_joints (+1 background channel)
    predicting heatmaps at feature resolution, NHWC out."""

    def __init__(self, num_features: int, num_joints: int = 16,
                 with_background: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        out_ch = num_joints + (1 if with_background else 0)
        self.pose_conv = nn.Conv2d(num_features, out_ch, 1)
        lecun_normal_(self.pose_conv.weight, generator)
        nn.init.zeros_(self.pose_conv.bias)

    def forward(self, feats):
        x = feats.to(torch.float32).permute(0, 3, 1, 2)
        return self.pose_conv(x).permute(0, 2, 3, 1)
