"""VGG-style preprocessing of decoded images with torch ops, on the image's
own device: the port of the JAX package's ``data/preprocessing_np.py``.

The geometry is drawn on the host with numpy, exactly as
``preprocess_decoded_np`` draws it: the short side (train: uniform in
[resize_min, resize_max]), then the crop's ``oy``, then ``ox``, then the
flip, from one ``numpy.random.Generator``.  The same seed gives the same
geometry and the same ``transform`` as the JAX package.  It is applied to a
decoded uint8 (H, W, 3) tensor: float32, bilinear resize
(``F.interpolate(align_corners=False, antialias=False)``, the
half-pixel-center sampling of ``cv2.resize(INTER_LINEAR)``; in float32
they agree to a few thousandths of a level on photographs and to 0.03 on
full-range noise, OpenCV rounding its weights), crop, flip, then round
and clip to uint8 (``keep_uint8``) or subtract the VGG means.

A clip (``preprocess_clip_np``) shares one geometry, drawn from its first
frame's size (:func:`draw_geometry`, with ``crop_frac`` for the diagonal
crops of multi-crop clip eval), and :func:`apply_clip` applies it to all
T frames, resizing a ragged frame to the first frame's size first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

R_MEAN, G_MEAN, B_MEAN = 123.68, 116.78, 103.94

__all__ = ["B_MEAN", "G_MEAN", "Geometry", "R_MEAN", "apply_clip",
           "apply_geometry", "apply_multicrop", "draw_geometry",
           "multicrop_geometry", "resize"]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where one crop of an (h, w) image comes from: the resized size, the
    crop's offset in it and the flip."""
    h: int
    w: int
    new_h: int
    new_w: int
    oy: int
    ox: int
    flip: bool

    def transform(self) -> np.ndarray:
        """float32 [scale_y, scale_x, offset_y, offset_x, flip], as the JAX
        package's preprocessing returns it."""
        return np.array([self.new_h / self.h, self.new_w / self.w,
                         float(self.oy), float(self.ox), float(self.flip)],
                        np.float32)


def _resized(h: int, w: int, side: int) -> tuple[int, int]:
    scale = side / min(h, w)
    return int(round(h * scale)), int(round(w * scale))


def draw_geometry(h: int, w: int, *, out_size: int, is_training: bool,
                  resize_min: int, resize_max: int | None = None,
                  rng: np.random.Generator | None = None,
                  crop_frac: float | None = None) -> Geometry:
    """The geometry ``preprocess_decoded_np`` (and ``preprocess_clip_np``,
    from the first frame's size) gives an (h, w) image: in training a
    random short side, crop and flip drawn from ``rng`` in that order; in
    eval the short side ``resize_min`` and the central crop, or with
    ``crop_frac`` the crop at that fraction of the spare extent along both
    axes."""
    if is_training and resize_max is not None and resize_max > resize_min:
        if rng is None:
            raise ValueError("training preprocessing needs an rng")
        side = int(rng.integers(resize_min, resize_max + 1))
    else:
        side = resize_min
    new_h, new_w = _resized(h, w, side)
    if is_training:
        if rng is None:
            raise ValueError("training preprocessing needs an rng")
        oy = int(rng.integers(0, max(new_h - out_size, 0) + 1))
        ox = int(rng.integers(0, max(new_w - out_size, 0) + 1))
        flip = bool(rng.integers(0, 2))
    elif crop_frac is not None:
        oy = int(round(max(new_h - out_size, 0) * crop_frac))
        ox = int(round(max(new_w - out_size, 0) * crop_frac))
        flip = False
    else:
        oy = max(new_h - out_size, 0) // 2
        ox = max(new_w - out_size, 0) // 2
        flip = False
    return Geometry(h, w, new_h, new_w, oy, ox, flip)


def multicrop_geometry(h: int, w: int, *, out_size: int, resize_min: int,
                       num_crops: int = 3) -> list[Geometry]:
    """``eval_multicrop_np``'s crops: short side ``resize_min``, crop ``i``
    at fraction ``i / (num_crops - 1)`` of the spare extent along both
    axes."""
    new_h, new_w = _resized(h, w, resize_min)
    max_oy, max_ox = max(new_h - out_size, 0), max(new_w - out_size, 0)
    out = []
    for i in range(num_crops):
        frac = i / max(num_crops - 1, 1)
        out.append(Geometry(h, w, new_h, new_w, int(round(max_oy * frac)),
                            int(round(max_ox * frac)), False))
    return out


def resize(image: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """A uint8 or float32 (H, W, 3) image as float32 (new_h, new_w, 3),
    bilinear with half-pixel centers and no antialiasing
    (``cv2.INTER_LINEAR``)."""
    x = image.to(torch.float32).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return x[0].permute(1, 2, 0)


def _finish(img: torch.Tensor, keep_uint8: bool) -> torch.Tensor:
    if keep_uint8:
        return img.round().clamp_(0, 255).to(torch.uint8)
    mean = torch.tensor([R_MEAN, G_MEAN, B_MEAN], dtype=torch.float32,
                        device=img.device)
    return img - mean


def _check(image: torch.Tensor, g: Geometry) -> None:
    if image.dtype != torch.uint8 or image.shape != (g.h, g.w, 3):
        raise ValueError(f"expected a uint8 ({g.h}, {g.w}, 3) image, got "
                         f"{image.dtype} {tuple(image.shape)}")


def apply_geometry(image: torch.Tensor, g: Geometry, *, out_size: int,
                   keep_uint8: bool = False) -> torch.Tensor:
    """One crop of a decoded uint8 (H, W, 3) image, on its device: uint8
    with ``keep_uint8``, else float32 minus the VGG means."""
    _check(image, g)
    img = resize(image, g.new_h, g.new_w)
    img = img[g.oy:g.oy + out_size, g.ox:g.ox + out_size]
    if g.flip:
        img = img.flip(1)
    return _finish(img, keep_uint8).contiguous()


def apply_multicrop(image: torch.Tensor, geoms: list[Geometry], *,
                    out_size: int) -> torch.Tensor:
    """(num_crops, out, out, 3) float32 mean-subtracted crops of one
    resize (``eval_multicrop_np``)."""
    g0 = geoms[0]
    _check(image, g0)
    img = _finish(resize(image, g0.new_h, g0.new_w), keep_uint8=False)
    return torch.stack([img[g.oy:g.oy + out_size, g.ox:g.ox + out_size]
                        for g in geoms])


def apply_clip(frames: list[torch.Tensor], g: Geometry, *, out_size: int,
               keep_uint8: bool = False) -> torch.Tensor:
    """(T, out, out, 3) crops of a clip's decoded uint8 frames at one
    shared geometry ``g`` (drawn from the first frame's size), on their
    device: a frame of another size is resized to the first's, as
    ``preprocess_clip_np`` does, before the shared resize."""
    out = []
    for frame in frames:
        if frame.dtype != torch.uint8 or frame.dim() != 3:
            raise ValueError(f"expected uint8 (H, W, 3) frames, got "
                             f"{frame.dtype} {tuple(frame.shape)}")
        img = frame
        if tuple(frame.shape[:2]) != (g.h, g.w):
            img = resize(frame, g.h, g.w)
        img = resize(img, g.new_h, g.new_w)
        img = img[g.oy:g.oy + out_size, g.ox:g.ox + out_size]
        if g.flip:
            img = img.flip(1)
        out.append(_finish(img, keep_uint8))
    return torch.stack(out)
