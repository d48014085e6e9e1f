"""Attention-map visualization: the per-class top-down map (X a_c) and the
bottom-up saliency (X b) as heatmap overlays on the input image.  Port of
the JAX package's ``utils/visualize.py``.

The JAX package draws with OpenCV (``cv2.resize`` and
``cv2.applyColorMap``); this module needs no OpenCV (the card's path
must not), and it draws on the maps' device: bilinear upsampling is
``F.interpolate`` (half-pixel centres, the edge pixels repeated, as
``cv2.resize(INTER_LINEAR)``), the JET colormap is the module's own
256 x 3 table (OpenCV's, entry for entry), and the blend repeats the JAX
package's numpy arithmetic (the image scaled in float32, the heat in
float64, truncated to uint8).  The maps come from the model's
``return_maps=True`` forward, whose logits run through the pooling
kernels on a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np
import torch
import torch.nn.functional as F

from attentionalpoolingaction_torch.data.preprocessing import (
    B_MEAN,
    G_MEAN,
    R_MEAN,
)

__all__ = ["JET", "attention_overlays", "clip_attention_overlays",
           "colorize", "make_attention_summary_hook", "normalize_map",
           "overlay_heatmap", "upsample_map"]

log = logging.getLogger(__name__)

# OpenCV's COLORMAP_JET as RGB rows for the levels 0..255
JET = np.frombuffer(bytes.fromhex(
    "00008000008400008800008c00009000009400009800009c0000a00000a40000"
    "a80000ac0000b00000b40000b80000bc0000c00000c40000c80000cc0000d000"
    "00d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc"
    "0000ff0004ff0008ff000cff0010ff0014ff0018ff001cff0020ff0024ff0028"
    "ff002cff0030ff0034ff0038ff003cff0040ff0044ff0048ff004cff0050ff00"
    "54ff0058ff005cff0060ff0064ff0068ff006cff0070ff0074ff0078ff007cff"
    "0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff00a0ff00a4ff00a8"
    "ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff00d0ff00"
    "d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2aff"
    "d62effd232ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56"
    "ffaa5affa65effa262ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff82"
    "82ff7e86ff7a8aff768eff7292ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff"
    "56aeff52b2ff4eb6ff4abaff46beff42c2ff3ec6ff3acaff36ceff32d2ff2ed6"
    "ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12f2ff0ef6ff0afaff06feff01"
    "fffc00fff800fff400fff000ffec00ffe800ffe400ffe000ffdc00ffd800ffd4"
    "00ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000ffac00ff"
    "a800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff54"
    "00ff5000ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff"
    "2800ff2400ff2000ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000"
    "fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d400"
    "00d00000cc0000c80000c40000c00000bc0000b80000b40000b00000ac0000a8"
    "0000a40000a000009c00009800009400009000008c0000880000840000800000"
), np.uint8).reshape(256, 3)


def _tensor(a, device=None) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a if device is None else a.to(device)


def upsample_map(feat_map, height: int, width: int) -> torch.Tensor:
    """Bilinear upsampling of a (h', w') map, or a stack (..., h', w'), to
    (..., height, width), float32, on the map's device."""
    m = _tensor(feat_map).to(torch.float32)
    lead = m.shape[:-2]
    m = m.reshape((-1, 1) + tuple(m.shape[-2:]))
    out = F.interpolate(m, size=(height, width), mode="bilinear",
                        align_corners=False)
    return out.reshape(lead + (height, width))


def normalize_map(m, dims=None) -> torch.Tensor:
    """``(m - min) / (max - min)`` over ``dims`` (default: all of ``m``),
    zeros where ``max - min < 1e-12``; float32.  The range is taken in
    float64 and rounded to float32 once, as the JAX package's numpy does
    with its Python floats."""
    m = _tensor(m).to(torch.float32)
    dims = tuple(range(m.ndim)) if dims is None else dims
    lo = m.amin(dim=dims, keepdim=True)
    span = m.amax(dim=dims, keepdim=True).double() - lo.double()
    out = (m - lo) / span.float()
    return torch.where(span < 1e-12, torch.zeros_like(out), out)


def colorize(m01: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (..., 3) of a map in [0, 1]: the JET colour of
    ``uint8(m * 255)`` (truncated, as numpy's ``astype`` does)."""
    table = torch.tensor(JET, device=m01.device)
    return table[(m01 * 255).to(torch.uint8).long()]


def _blend(rgb: torch.Tensor, heat: torch.Tensor, alpha: float
           ) -> torch.Tensor:
    """``(1 - alpha) * rgb + alpha * heat``, clipped to uint8, in the JAX
    package's numpy dtypes: the image term float32, the heat term and the
    sum float64."""
    out = ((rgb.to(torch.float32) * (1 - alpha)).double()
           + heat.double() * alpha)
    return out.clamp(0, 255).to(torch.uint8)


def overlay_heatmap(image_rgb, attn, alpha: float = 0.5, *,
                    prenormalized: bool = False) -> torch.Tensor:
    """Blend an attention map, or a stack of them, over uint8 RGB
    images (..., H, W, 3) in the JET colormap; uint8 RGB on the map's
    device.  Each map is upsampled to the image, then stretched to [0, 1]
    over its own min/max, or with ``prenormalized`` (maps normalized over a
    larger scope, such as a whole clip) clipped to [0, 1]."""
    attn = _tensor(attn)
    image = _tensor(image_rgb, attn.device)
    h, w = image.shape[-3:-1]
    m = upsample_map(attn, h, w)
    m = m.clamp(0.0, 1.0) if prenormalized else normalize_map(m, (-2, -1))
    return _blend(image, colorize(m), alpha)


def _rgb(images: torch.Tensor) -> torch.Tensor:
    """uint8 RGB of mean-subtracted float32 images."""
    mean = images.new_tensor([R_MEAN, G_MEAN, B_MEAN])
    return (images + mean).clamp(0, 255).to(torch.uint8)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@contextlib.contextmanager
def _eval_mode(model):
    """The model in eval mode under ``no_grad``, as the JAX package
    applies it (``train=False``), then back in the mode it was in: a
    forward in train mode would move batch norm's running statistics."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(was_training)


def attention_overlays(model, images, *, class_idx=None,
                       alpha: float = 0.5) -> dict:
    """Overlays of (B, H, W, 3) float32 mean-subtracted images: the model's
    ``return_maps=True`` forward on its device, in eval mode.
    ``class_idx``: an int, a (B,) array, or None for each image's arg-max
    class.  Returns ``top_down`` and
    ``saliency``, lists of uint8 RGB (H, W, 3) arrays, and the numpy
    ``logits``, ``attn_maps`` (B, h', w', C), ``saliency_maps`` (B, h', w')
    and ``class_idx`` (B,)."""
    x = _tensor(images, _model_device(model)).to(torch.float32)
    with _eval_mode(model):
        out = model(x, return_maps=True)
        logits, maps, sal = out["logits"], out["attn_maps"], out["saliency"]
        if class_idx is None:
            cls = logits.argmax(-1)
        else:
            cls = torch.as_tensor(np.broadcast_to(np.asarray(class_idx),
                                                  (len(maps),)).copy(),
                                  device=maps.device)
        top_maps = maps[torch.arange(len(maps), device=maps.device), :, :,
                        cls]
        rgb = _rgb(x)
        top = overlay_heatmap(rgb, top_maps, alpha)
        bottom = overlay_heatmap(rgb, sal, alpha)
    return {"top_down": list(top.cpu().numpy()),
            "saliency": list(bottom.cpu().numpy()),
            "logits": logits.cpu().numpy(), "attn_maps": maps.cpu().numpy(),
            "saliency_maps": sal.cpu().numpy(),
            "class_idx": cls.cpu().numpy()}


def clip_attention_overlays(model, clip, *, class_idx=None,
                            alpha: float = 0.5) -> dict:
    """Spatiotemporal overlays of ONE clip, (T, H, W, 3) float32
    mean-subtracted frames in temporal order: the 5-D forward with
    ``return_maps=True`` gives the video-level prediction's top-down map
    and the saliency per frame, and all frames share ONE normalization so
    that hot frames read hot against the whole clip.  Returns
    ``top_down``/``saliency`` lists of T uint8 RGB overlays, the numpy
    ``logits`` (C,), ``attn_maps`` (T, h, w, C), ``saliency_maps`` (T, h,
    w), the video-level ``class_idx`` and ``temporal_attention``: each
    frame's share of the clip's positive attention mass for that class."""
    x = _tensor(clip, _model_device(model)).to(torch.float32)
    with _eval_mode(model):
        out = model(x[None], return_maps=True)
        logits = out["logits"][0]
        maps, sal = out["attn_maps"][0], out["saliency"][0]
        c = int(logits.argmax()) if class_idx is None else int(class_idx)
        top_maps = maps[..., c]                              # (T, h, w)
        rgb = _rgb(x)
        top = overlay_heatmap(rgb, normalize_map(top_maps), alpha,
                              prenormalized=True)
        bottom = overlay_heatmap(rgb, normalize_map(sal), alpha,
                                 prenormalized=True)
        mass = top_maps.clamp_min(0.0).sum(dim=(1, 2))
    mass = mass.cpu().numpy()
    temporal = (mass / mass.sum() if mass.sum() > 0
                else np.full(len(mass), 1.0 / len(mass)))
    return {"top_down": list(top.cpu().numpy()),
            "saliency": list(bottom.cpu().numpy()),
            "logits": logits.cpu().numpy(), "attn_maps": maps.cpu().numpy(),
            "saliency_maps": sal.cpu().numpy(), "class_idx": c,
            "temporal_attention": temporal}


def make_attention_summary_hook(cfg, writer, every: int,
                                num_images: int = 4, *, device=None):
    """Train-loop hook ``hook(step, state, metrics)`` that writes
    attention overlays of a fixed probe batch as image summaries
    (``writer.write_images``: ``attention/top_down``,
    ``attention/saliency``) every ``every`` steps, from the CURRENT
    weights, so that TensorBoard's image slider shows attention sharpen
    as training goes on.  The probe (the first ``num_images`` examples of
    the eval split, else of the train split; crop 0 of a multicrop split)
    is read once, at the first firing, on ``device`` (default: the
    model's).  The model runs in eval mode under ``no_grad`` and goes back
    to train mode (:func:`attention_overlays`)."""
    from attentionalpoolingaction_torch import evaluate as eval_lib
    from attentionalpoolingaction_torch import train as train_lib
    from attentionalpoolingaction_torch.data.datasets import get_dataset

    if cfg.pooling == "avg":
        raise ValueError("attention summaries need an attention head; "
                         f"pooling={cfg.pooling!r}")
    probe: dict = {}

    def hook(step, state, metrics):
        del metrics
        if every <= 0 or step % every:
            return
        model = state.model
        if model.head.class_group is not None:
            # a class shard of the head (a model axis): the maps need
            # every class, so they are drawn from the whole state
            whole = train_lib.build_model(cfg, device=_model_device(model))
            whole.load_state_dict(state.full_state_dict())
            model = whole
        if "images" not in probe:
            cfg_probe = cfg
            if not cfg.eval_pattern:
                cfg_probe = dataclasses.replace(
                    cfg, eval_pattern=cfg.train_pattern)
            it = eval_lib.make_eval_input(
                cfg_probe, get_dataset(cfg.dataset),
                device=device or _model_device(model))
            imgs = next(iter(it))["image"][:num_images]
            if imgs.ndim == 5:          # multicrop eval: crop 0
                imgs = imgs[:, 0]
            probe["images"] = train_lib.normalize_images(
                _tensor(imgs, _model_device(model)))
        out = attention_overlays(model, probe["images"])
        writer.write_images(step, {
            "attention/top_down": np.stack(out["top_down"]),
            "attention/saliency": np.stack(out["saliency"]),
        })

    return hook
