"""Numerical ops of the port: attentional pooling and its CUDA kernels."""

from attentionalpoolingaction_torch.ops.attn_pool import (
    attention_maps,
    attentional_pool,
    attentional_pool_oracle,
)

__all__ = [
    "attentional_pool",
    "attentional_pool_oracle",
    "attention_maps",
]
