"""Plain reference of the model: TF-slim ResNet-v1 and rank-P attentional
pooling (Girdhar & Ramanan, NeurIPS 2017, arXiv 1711.01467), as plain
torch functions of a Flax-layout weight tree.  Imports nothing of the
port.

Slim's semantics: a strided conv pads ``kernel - 1`` symmetrically
(floor before, ceil after) and runs VALID; the root max-pool is 3x3
stride 2 with TF "SAME" padding (-inf, the odd cell at the end); the
stride of a block sits on its last unit (its 3x3 conv and its projection
shortcut; an identity shortcut subsamples); batch norm has eps 1e-5 and
in train mode normalizes with the batch mean and biased variance and
moves its running statistics toward both by ``1 - decay``; v1 is
post-activation, ``relu(shortcut + residual)``.

The head, for features X (n x f) and class c:
``logit_c = sum_p (X a_cp + alpha_cp)^T (X b_p + beta_p)``, computed as
``s = X b + beta``, ``v = X^T s``, ``logit = <v, a_c> + alpha_c . sum(s)``.

``dtype`` is the precision of the convs and the activations between
them: float32 (the caller turns TF32 off), or bfloat16 for the control,
where each conv takes bfloat16 inputs and weights and batch norm reduces
and normalizes in float32 and rounds to bfloat16.  The head runs in
float32 either way.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
VGG_MEANS = (123.68, 116.78, 103.94)


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convs, TF32 off, for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _conv(x, kernel, stride: int):
    """Slim conv2d_same of NCHW ``x`` with an HWIO ``kernel``."""
    kh = kernel.shape[0]
    w = kernel.permute(3, 2, 0, 1).to(x.dtype)
    if stride == 1:
        return F.conv2d(x, w, padding=kh // 2)
    lo = (kh - 1) // 2
    x = F.pad(x, (lo, kh - 1 - lo, lo, kh - 1 - lo))
    return F.conv2d(x, w, stride=stride)


def _max_pool_same(x, k: int = 3, s: int = 2):
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


class Norms:
    """Batch norm over a Flax tree: train mode (batch statistics, running
    update collected in ``updates``) or eval mode (running statistics)."""

    def __init__(self, params, stats, train: bool, decay: float):
        self.params, self.stats = params, stats
        self.train, self.decay = train, decay
        self.updates = {}

    def __call__(self, x, path: tuple):
        p = _get(self.params, path)
        st = _get(self.stats, path)
        xf = x.to(_wide(x.dtype))
        if self.train:
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean[None, :, None, None]).square().mean(
                dim=(0, 2, 3))
            m = 1.0 - self.decay
            self.updates[path] = (
                st["mean"] + m * (mean.detach() - st["mean"]),
                st["var"] + m * (var.detach() - st["var"]))
        else:
            mean, var = st["mean"], st["var"]
        y = ((xf - mean[None, :, None, None])
             * (torch.rsqrt(var + BN_EPS) * p["scale"])[None, :, None, None]
             + p["bias"][None, :, None, None])
        return y.to(x.dtype)


def _wide(dtype):
    """Where batch norm and the head compute: float32 for a 16-bit dtype,
    else the dtype itself."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else (
        dtype)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def resnet_features(params, stats, x, *, stages, train: bool,
                    decay: float = 0.997, dtype=torch.float32):
    """NHWC float32 features (B, h, w, 2048) of mean-subtracted NHWC
    float32 images, and the batch norms' running updates (train mode)."""
    bn = Norms(params, stats, train, decay)
    r = params["resnet"]
    h = x.permute(0, 3, 1, 2).to(dtype)
    h = F.relu(bn(_conv(h, r["conv1"]["kernel"], 2), ("resnet", "conv1_bn")))
    h = _max_pool_same(h)
    depth_in = 64
    for b, units in enumerate(stages, start=1):
        base = 64 * 2 ** (b - 1)
        block_stride = 1 if b == len(stages) else 2
        for u in range(1, units + 1):
            name = f"block{b}/unit_{u}"
            unit = r[name]
            path = ("resnet", name)
            stride = block_stride if u == units else 1
            if depth_in != base * 4:
                sc = bn(_conv(h, unit["shortcut"]["kernel"], stride),
                        path + ("shortcut_bn",))
            else:
                sc = h if stride == 1 else h[:, :, ::stride, ::stride]
            y = F.relu(bn(_conv(h, unit["conv1"]["kernel"], 1),
                          path + ("conv1_bn",)))
            y = F.relu(bn(_conv(y, unit["conv2"]["kernel"], stride),
                          path + ("conv2_bn",)))
            y = bn(_conv(y, unit["conv3"]["kernel"], 1), path + ("conv3_bn",))
            h = F.relu(sc + y)
            depth_in = base * 4
    return h.permute(0, 2, 3, 1).to(_wide(dtype)), bn.updates


def attentional_pool(x, attn_w, attn_b, sal_w, sal_b):
    """(B, C) logits of (B, N, F) features, rank P = ``sal_w.shape[1]``."""
    s = torch.einsum("bnf,fp->bnp", x, sal_w) + sal_b
    v = torch.einsum("bnf,bnp->bfp", x, s)
    return (torch.einsum("bfp,fcp->bc", v, attn_w)
            + torch.mm(s.sum(dim=1), attn_b.t()))


def normalize(images_u8):
    """uint8 NHWC RGB -> float32 minus the VGG means."""
    x = images_u8.to(torch.float32)
    return x - torch.tensor(VGG_MEANS, dtype=torch.float32, device=x.device)


def logits(params, stats, images_u8, *, stages, train: bool = False,
           decay: float = 0.997, dtype=torch.float32):
    """(B, C) float32 logits of uint8 NHWC images, and the batch norms'
    running updates (train mode)."""
    feats, updates = resnet_features(params, stats,
                                     normalize(images_u8).to(_wide(dtype)),
                                     stages=stages, train=train,
                                     decay=decay, dtype=dtype)
    b, hh, ww, f = feats.shape
    hd = params["head"]
    out = attentional_pool(feats.reshape(b, hh * ww, f), hd["attn_w"],
                           hd["attn_b"], hd["sal_w"], hd["sal_b"])
    return out, updates
