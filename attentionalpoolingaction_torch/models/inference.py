"""Serving-path inference: the BN-folded forward, float or post-training
int8.  Port of the JAX package's ``models/inference.py``.

In eval mode batch norm is an affine map, so it folds into the epilogue of
the conv before it:

    BN(conv(x, W)) = conv(x, W) * s + t,   s = gamma / sqrt(var + eps),
                                           t = beta - mean * s.

:func:`fold_backbone` walks the Flax-layout ``{"params", "batch_stats"}``
arrays (the same trees the weight bridge, ``convert.py``, takes) and the
forward is rebuilt from plain convolutions with the fold applied and
slim's ``conv2d_same`` padding, in NHWC as the JAX package runs it:

  * float (float32 or bfloat16 activations): ``F.conv2d``; it matches the
    ``ActionModel`` forward to ~1e-5 relative.
  * int8: per-output-channel symmetric int8 weights with the BN scale in
    the dequantization constant (:func:`quantize_folded`); activations
    quantized to int8 with a static per-conv scale
    (:func:`calibrate_act_scales`) or one per example (its absmax), so
    that a prediction never depends on its batch-mates.  PyTorch has no
    int8 convolution, so the int32 accumulator JAX's
    ``conv_general_dilated`` gives is ``torch._int_mm`` (int8 x int8 ->
    int32) over an im2col matrix: a 1x1 conv is a reshape, a kxk conv a
    ``Tensor.unfold`` view copied into (B*Ho*Wo, C*k*k) rows (``F.unfold``
    takes no int8).  CUDA's ``_int_mm`` wants more than 16 rows and K and
    N multiples of 8: K is zero-padded (the root conv's 147 to 152) and a
    short matrix gets zero rows, which leaves the accumulator as it is.
    Then ``acc * (s_x * scale) + bias``, cast to the compute dtype, in the
    JAX package's order.

The attentional-pooling head stays float32 and runs through
``ops/attn_pool_cuda.attentional_pool_fused``: on a CUDA tensor the two
hand-written kernels, on a CPU tensor their plain versions.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models.resnet import (
    BACKBONES,
    BN_EPS,
    max_pool_same,
)
from attentionalpoolingaction_torch.ops import attn_pool_cuda

__all__ = ["calibrate_act_scales", "fold_backbone", "folded_forward",
           "head_weights", "int8_matmul", "make_int8_forward",
           "quantize_folded", "scale_tensors"]

_STAGE_STRIDES = (2, 2, 2, 1)
_K_ALIGN = 8            # CUDA _int_mm: K and N multiples of 8
_MIN_ROWS = 17          # CUDA _int_mm: more than 16 rows


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` rounded once: the divisor is a tensor on ``t``'s device,
    since CUDA divides by a host scalar as a product with its reciprocal.
    It is made by an op (``new_full``), not as a constant, so that a traced
    program holds no tensor bound to the device it was traced on."""
    return t / t.new_full((), 127.0)


def _stage_sizes(backbone: str):
    try:
        return BACKBONES[backbone].keywords["stage_sizes"]
    except KeyError:
        raise ValueError(f"unknown backbone {backbone!r}") from None


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(a, np.float32))


def _fold(conv_params, bn_params, bn_stats, eps=BN_EPS, device=None):
    """Eval-mode BN folded into the conv's output scale and bias, on the
    host; the HWIO kernel becomes OIHW.  ``1 / sqrt(var + eps)`` is taken
    in float64 and rounded once (XLA's float32 rsqrt on the CPU is not
    correctly rounded, so no float32 formula matches it bit for bit), the
    rest in float32 as the JAX package computes it."""
    inv = torch.rsqrt((_f32(bn_stats["var"]) + eps).double()).float()
    scale = _f32(bn_params["scale"]) * inv
    bias = _f32(bn_params["bias"]) - _f32(bn_stats["mean"]) * scale
    kernel = _f32(conv_params["kernel"]).permute(3, 2, 0, 1).contiguous()
    return {"kernel": kernel.to(device), "scale": scale.to(device),
            "bias": bias.to(device)}


def fold_backbone(variables, backbone: str = "resnet_v1_101", *,
                  device=None) -> dict:
    """Flax-layout ``variables`` (params + batch_stats of the
    ActionModel) -> the folded backbone on ``device`` (default ``cuda``).

    Keys follow the parameter tree (``"conv1"``, ``"block1/unit_1"`` ->
    a dict of its convs), so that calibration ids match checkpoint names.
    """
    device = resolve_device(device)
    params = variables["params"]["resnet"]
    stats = variables["batch_stats"]["resnet"]
    fold = functools.partial(_fold, device=device)
    folded = {"conv1": fold(params["conv1"], params["conv1_bn"],
                            stats["conv1_bn"])}
    for b, num_units in enumerate(_stage_sizes(backbone), start=1):
        for u in range(1, num_units + 1):
            key = f"block{b}/unit_{u}"
            up, us = params[key], stats[key]
            unit = {c: fold(up[c], up[f"{c}_bn"], us[f"{c}_bn"])
                    for c in ("conv1", "conv2", "conv3")}
            if "shortcut" in up:
                unit["shortcut"] = fold(up["shortcut"], up["shortcut_bn"],
                                        us["shortcut_bn"])
            folded[key] = unit
    return folded


def quantize_folded(folded: dict) -> dict:
    """Per-output-channel symmetric int8 weights (OIHW ``kernel_q``), the
    BN scale folded into the dequantization constant, so that a conv is
    ``acc_i32 * (s_x * scale) + bias`` and nothing else.  Rounds half to
    even, as ``jnp.round`` does."""
    def q(layer):
        if "kernel" not in layer:        # a unit's dict of convs
            return {k: q(v) for k, v in layer.items()}
        w = layer["kernel"]
        wmax = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8)
        wscale = _div127(wmax)
        return {"kernel_q": torch.round(w / wscale[:, None, None, None])
                .to(torch.int8),
                "scale": wscale * layer["scale"],
                "bias": layer["bias"]}
    return {k: q(v) for k, v in folded.items()}


def head_weights(params: Mapping, device=None) -> dict:
    """The heads of Flax-layout ``params`` as float32 tensors on ``device``
    (default ``cuda``): ``{"head": ..., "pose_head": ... or None}``.  The
    attention head carries ``w_pfc``, the kernels' (P, F, C) copy of
    ``attn_w``, made once here instead of at every call."""
    device = resolve_device(device)

    def tree(t):
        return {k: tree(v) if isinstance(v, Mapping) else _f32(v).to(device)
                for k, v in t.items()}

    head = tree(params["head"])
    if "attn_w" in head:
        head["w_pfc"] = attn_pool_cuda.attn_w_pfc(head["attn_w"])
    pose = params.get("pose_head")
    return {"head": head, "pose_head": tree(pose) if pose is not None
            else None}


def int8_matmul(a: torch.Tensor, w: torch.Tensor,
                least_rows: int | None = None) -> torch.Tensor:
    """int32 (M, N) = int8 ``a`` (M, K) times int8 ``w`` (N, K) transposed,
    by ``torch._int_mm``.  Zero rows make M at least 17 (CUDA's
    ``_int_mm`` wants more than 16) and are dropped again, on every device,
    so that a program traced on the CPU runs on a card; they leave the
    accumulator's rows as they are.  ``least_rows`` is the least M at any
    batch (the rows of one image): where it is 17 or more no pad is
    needed; else the pad is ``max(17 - M, 0)`` rows, which a trace at a
    symbolic batch keeps as an expression, so that it sets no guard on the
    batch."""
    m = a.shape[0]
    if (m if least_rows is None else least_rows) < _MIN_ROWS:
        pad = torch.sym_max(_MIN_ROWS - m, 0)
        if not isinstance(pad, int) or pad > 0:
            a = F.pad(a, (0, 0, 0, pad))
    return torch._int_mm(a, w.t())[:m]


def _same_pads(kernel_size: int) -> tuple[int, int]:
    """slim ``conv2d_same``: symmetric (floor, ceil) padding of k - 1; for
    an odd kernel at stride 1 it is TF's "SAME" too."""
    total = kernel_size - 1
    return total // 2, total - total // 2


def _int8_conv(xq: torch.Tensor, kernel_q: torch.Tensor, kernel_size: int,
               stride: int) -> torch.Tensor:
    """The int32 accumulator (B, Ho, Wo, O) of an int8 NHWC ``xq`` and an
    int8 OIHW ``kernel_q`` with ``conv2d_same`` padding, as an im2col
    matrix product.  Rows of the matrix are output pixels, columns (C, kh,
    kw), the order of ``kernel_q.reshape(O, -1)``."""
    b, _, _, c = xq.shape
    o = kernel_q.shape[0]
    k_dim = c * kernel_size * kernel_size
    k_pad = -(-k_dim // _K_ALIGN) * _K_ALIGN
    if kernel_size == 1:
        if stride != 1:
            xq = xq[:, ::stride, ::stride]
        ho, wo = xq.shape[1:3]
        cols = xq.reshape(-1, c)
    else:
        beg, end = _same_pads(kernel_size)
        xq = F.pad(xq, (0, 0, beg, end, beg, end))
        patches = xq.unfold(1, kernel_size, stride).unfold(
            2, kernel_size, stride)                  # (B, Ho, Wo, C, k, k)
        ho, wo = patches.shape[1:3]
        if k_pad == k_dim:
            cols = patches.reshape(-1, k_dim)
        else:
            cols = xq.new_zeros((b * ho * wo, k_pad))
            cols[:, :k_dim].view(patches.shape).copy_(patches)
    w = kernel_q.reshape(o, -1)
    if k_pad != k_dim:
        w = F.pad(w, (0, k_pad - k_dim))
    return int8_matmul(cols, w, least_rows=ho * wo).view(b, ho, wo, o)


def _float_conv(x: torch.Tensor, kernel: torch.Tensor, kernel_size: int,
                stride: int, as_matmul: bool) -> torch.Tensor:
    """NHWC conv (or, with ``as_matmul``, a 1x1 stride-1 conv as one
    matrix product) in ``x``'s dtype; returns float32 NHWC."""
    if as_matmul:
        b, h, w, c = x.shape
        y = x.reshape(-1, c) @ kernel.reshape(kernel.shape[0], c).t()
        return y.view(b, h, w, -1).to(torch.float32)
    if stride == 1:
        pad = _same_pads(kernel_size)[0]
    else:
        beg, end = _same_pads(kernel_size)
        x = F.pad(x, (0, 0, beg, end, beg, end))
        pad = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).to(torch.float32)


def _act_scale(x: torch.Tensor, cid: str, act_scales) -> torch.Tensor:
    """The activation scale of conv ``cid``: the static one, a float32
    scalar tensor on ``x``'s device (a weight, :func:`scale_tensors`; a
    float is made one here), or per example, ``max(absmax, 1e-6) / 127``
    in ``x``'s dtype (shape (B, 1, 1, 1)), as the JAX package computes
    it."""
    if act_scales is not None and cid in act_scales:
        s = act_scales[cid]
        return s if isinstance(s, torch.Tensor) else torch.tensor(
            np.float32(s), device=x.device)
    return _div127(x.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-6))


def scale_tensors(act_scales, device) -> dict | None:
    """Static activation scales as float32 scalar tensors on ``device``:
    weights of the forward, which a traced program takes as inputs.
    Tensors pass as they are."""
    if act_scales is None:
        return None
    return {cid: s if isinstance(s, torch.Tensor)
            else torch.tensor(np.float32(s), device=device)
            for cid, s in act_scales.items()}


def _conv(x, layer, kernel_size, stride, *, cid, act_scales, capture, dtype,
          dot_1x1=False):
    """One folded conv of NHWC ``x`` with slim ``conv2d_same`` padding;
    int8 where ``layer`` holds ``kernel_q``.  ``capture`` (calibration)
    records the absmax of the input by ``cid``."""
    if capture is not None:
        capture[cid] = max(capture.get(cid, 0.0), float(x.abs().max()))
    if "kernel_q" in layer:
        s_x = _act_scale(x, cid, act_scales)
        xq = torch.round(x.to(torch.float32) / s_x).clamp_(-127, 127).to(
            torch.int8)
        acc = _int8_conv(xq, layer["kernel_q"], kernel_size, stride)
        y = acc.to(torch.float32) * (s_x * layer["scale"]) + layer["bias"]
    else:
        as_matmul = dot_1x1 and kernel_size == 1 and stride == 1
        y = _float_conv(x.to(dtype), layer["kernel"].to(dtype), kernel_size,
                        stride, as_matmul)
        y = y * layer["scale"] + layer["bias"]
    return y.to(dtype)


def folded_forward(folded, head, images, *, backbone: str = "resnet_v1_101",
                   pooling: str = "attention", act_scales: dict | None = None,
                   capture: dict | None = None,
                   dtype: torch.dtype = torch.bfloat16, pose_head=None,
                   dot_1x1: bool = False) -> dict:
    """images (mean-subtracted float NHWC, or (B, T, H, W, 3) clips) ->
    folded backbone -> head: ``{"features", "logits"[, "pose_heatmaps"]}``,
    float32.

    ``folded`` is :func:`fold_backbone`'s (float) or
    :func:`quantize_folded`'s (int8, told apart per layer); ``head`` and
    ``pose_head`` are :func:`head_weights`'s.  Without ``act_scales`` the
    int8 convs quantize their inputs per example.  A clip's frames fold
    into the conv batch and unfold before the head, which pools over all
    T*h*w positions, as the ActionModel's 5-D path does."""
    clip_t = None
    if images.dim() == 5:
        if pose_head is not None:
            raise ValueError("pose_head is per-image; no clip support")
        b0, clip_t = images.shape[:2]
        images = images.reshape((b0 * clip_t,) + tuple(images.shape[2:]))
    conv = functools.partial(_conv, act_scales=act_scales, capture=capture,
                             dtype=dtype, dot_1x1=dot_1x1)
    x = F.relu(conv(images.to(dtype), folded["conv1"], 7, 2, cid="conv1"))
    x = max_pool_same(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    for b, num_units in enumerate(_stage_sizes(backbone), start=1):
        block_stride = _STAGE_STRIDES[b - 1]
        for u in range(1, num_units + 1):
            key = f"block{b}/unit_{u}"
            unit = folded[key]
            stride = block_stride if u == num_units else 1
            if "shortcut" in unit:
                shortcut = conv(x, unit["shortcut"], 1, stride,
                                cid=f"{key}/shortcut")
            else:
                shortcut = x if stride == 1 else x[:, ::stride, ::stride]
            r = F.relu(conv(x, unit["conv1"], 1, 1, cid=f"{key}/conv1"))
            r = F.relu(conv(r, unit["conv2"], 3, stride,
                            cid=f"{key}/conv2"))
            r = conv(r, unit["conv3"], 1, 1, cid=f"{key}/conv3")
            x = F.relu(shortcut + r)

    feats = x.to(torch.float32)
    if clip_t is not None:
        bt, fh, fw, ff = feats.shape
        feats = feats.reshape(bt // clip_t, clip_t * fh, fw, ff)
    bsz, h, w, f = feats.shape
    out = {"features": feats}
    if pooling == "avg":
        dense = head["logits"]
        out["logits"] = feats.mean(dim=(1, 2)) @ dense["kernel"] + \
            dense["bias"]
    else:
        out["logits"] = attn_pool_cuda.attentional_pool_fused(
            feats.reshape(bsz, h * w, f).contiguous(), head["attn_w"],
            head["attn_b"], head["sal_w"], head["sal_b"],
            w_pfc=head.get("w_pfc"))
    if pose_head is not None:
        k = pose_head["pose_conv"]
        out["pose_heatmaps"] = feats @ k["kernel"].reshape(f, -1) + k["bias"]
    return out


def calibrate_act_scales(folded, head, batches, *,
                         backbone: str = "resnet_v1_101",
                         pooling: str = "attention",
                         margin: float = 1.0) -> dict:
    """Run the float32 folded forward over calibration ``batches``
    (mean-subtracted float (B, H, W, 3) arrays or tensors), recording each
    conv input's absmax: ``{conv_id: static int8 activation scale}``."""
    capture: dict = {}
    device = folded["conv1"]["kernel"].device
    with torch.inference_mode():
        for images in batches:
            folded_forward(folded, head,
                           torch.as_tensor(images, dtype=torch.float32,
                                           device=device),
                           backbone=backbone, pooling=pooling,
                           capture=capture, dtype=torch.float32)
    return {cid: float(np.float32(amax)) / 127.0 * margin
            for cid, amax in capture.items()}


def make_int8_forward(variables, *, backbone: str = "resnet_v1_101",
                      pooling: str = "attention", calibration_batches=None,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> Any:
    """Fold, (optionally) calibrate and quantize ``variables`` on
    ``device`` (default ``cuda``); returns ``fn(images) -> outputs``."""
    device = resolve_device(device)
    folded = fold_backbone(variables, backbone, device=device)
    heads = head_weights(variables["params"], device)
    act_scales = None
    if calibration_batches is not None:
        act_scales = scale_tensors(calibrate_act_scales(
            folded, heads["head"], calibration_batches, backbone=backbone,
            pooling=pooling), device)
    qfolded = quantize_folded(folded)

    @torch.inference_mode()
    def fwd(images):
        return folded_forward(qfolded, heads["head"], images,
                              backbone=backbone, pooling=pooling,
                              act_scales=act_scales, dtype=dtype,
                              pose_head=heads["pose_head"])
    return fwd
