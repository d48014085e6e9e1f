"""Low-rank second-order attentional pooling (Girdhar & Ramanan, NeurIPS'17),
in PyTorch.  Port of the JAX package's ``ops/attn_pool.py``.

For a feature map ``X in R^{n x f}`` and class c, with P rank pairs:

    logits_c = sum_p (X a_{c,p} + alpha_{c,p} 1)^T (X b_p + beta_p 1)

The factorized form uses ``(X a_c)^T (X b) = a_c^T (X^T (X b))``: a
saliency ``s = X b + beta`` (n x P), a feature-space summary ``v = X^T s``
(f x P), then ``logits = einsum(v, A)``, with no n-by-C buffer.

All functions take the JAX layouts:
    x:      (B, N, F)   flattened spatial features (NHWC order)
    attn_w: (F, C, P)   top-down per-class weights
    attn_b: (C, P)      top-down biases
    sal_w:  (F, P)      bottom-up (saliency) weights
    sal_b:  (P,)        bottom-up biases
and accumulate in float32 whatever the input dtype.
"""

from __future__ import annotations

import torch


def _f32(*tensors):
    return [t.to(torch.float32) for t in tensors]


def attentional_pool_oracle(x, attn_w, attn_b, sal_w, sal_b):
    """Naive reference: materialize both maps, then contract.  A test
    oracle for :func:`attentional_pool` and the kernels."""
    x, attn_w, attn_b, sal_w, sal_b = _f32(x, attn_w, attn_b, sal_w, sal_b)
    top = torch.einsum("bnf,fcp->bncp", x, attn_w) + attn_b[None, None]
    bot = torch.einsum("bnf,fp->bnp", x, sal_w) + sal_b[None, None]
    return torch.einsum("bncp,bnp->bc", top, bot)


def attentional_pool(x, attn_w, attn_b, sal_w, sal_b):
    """Factorized attentional pooling: ``logits = A^T (X^T (X b))``."""
    x, attn_w, attn_b, sal_w, sal_b = _f32(x, attn_w, attn_b, sal_w, sal_b)
    s = torch.einsum("bnf,fp->bnp", x, sal_w) + sal_b
    v = torch.einsum("bnf,bnp->bfp", x, s)
    logits = torch.einsum("bfp,fcp->bc", v, attn_w)
    return logits + torch.einsum("bp,cp->bc", s.sum(dim=1), attn_b)


def attention_maps(x, attn_w, attn_b, sal_w, sal_b, *, class_idx=None):
    """Materialize attention maps for visualization.

    Returns ``(top_down, bottom_up)``: ``top_down`` is (B, N, C) with the
    rank summed and ``bottom_up`` is (B, N).  ``class_idx`` (an int, or a
    (B,) index per example) restricts the top-down map to one class.
    """
    x, attn_w, attn_b, sal_w, sal_b = _f32(x, attn_w, attn_b, sal_w, sal_b)
    bot = torch.einsum("bnf,fp->bnp", x, sal_w) + sal_b
    bottom_up = bot.sum(dim=-1)
    if class_idx is not None:
        class_idx = torch.as_tensor(class_idx, device=x.device)
        aw_c = attn_w[:, class_idx, :]          # (F, P) or (F, B, P)
        ab_c = attn_b[class_idx, :]
        if aw_c.ndim == 3:                      # per-example class selection
            top = torch.einsum("bnf,fbp->bnp", x, aw_c) + ab_c[:, None, :]
        else:
            top = torch.einsum("bnf,fp->bnp", x, aw_c) + ab_c[None, None, :]
    else:
        top = torch.einsum("bnf,fcp->bncp", x, attn_w) + attn_b[None, None]
    return top.sum(dim=-1), bottom_up


def init_attn_pool_params(generator: torch.Generator, num_features,
                          num_classes, rank=1, dtype=torch.float32,
                          stddev=0.01):
    """Truncated-normal (two standard deviations) 1x1 conv weights and zero
    biases.  ``models/heads.py`` uses a (n*f)^-1/2 stddev instead."""

    def trunc(shape):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0,
                                    generator=generator)
        return (t * stddev).to(dtype)

    return {
        "attn_w": trunc((num_features, num_classes, rank)),
        "attn_b": torch.zeros((num_classes, rank), dtype=dtype),
        "sal_w": trunc((num_features, rank)),
        "sal_b": torch.zeros((rank,), dtype=dtype),
    }
