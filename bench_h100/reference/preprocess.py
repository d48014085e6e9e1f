"""Plain reference of the input path: OpenCV decode, then the VGG-style
geometry of the paper's code (``preprocess_decoded_np``): the short side
to ``resize_min`` (training: drawn in ``[resize_min, resize_max]``), the
crop's top, its left and the flip drawn in that order from one numpy
generator, bilinear resize with half-pixel centres and no antialiasing,
crop, flip, round to uint8.

The training stream's order and draws are the documented contract of the
records pipeline: epoch ``e`` visits the records in the permutation of
``numpy.random.default_rng([1, seed, e])``, and the example at position
``p`` of epoch ``e`` draws its geometry from
``numpy.random.default_rng([2, seed, e, p])``; batches run on across
epochs.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch
import torch.nn.functional as F


def decode(data: bytes) -> np.ndarray:
    """RGB uint8 (H, W, 3) of JPEG bytes (a grey JPEG gives three equal
    channels)."""
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("OpenCV could not decode the image")
    return np.ascontiguousarray(img[..., ::-1])


def resized_size(h: int, w: int, side: int) -> tuple[int, int]:
    scale = side / min(h, w)
    return int(round(h * scale)), int(round(w * scale))


def geometry(h, w, *, out_size, train, resize_min, resize_max=None,
             rng=None):
    """(new_h, new_w, oy, ox, flip) of one crop."""
    if train and resize_max is not None and resize_max > resize_min:
        side = int(rng.integers(resize_min, resize_max + 1))
    else:
        side = resize_min
    nh, nw = resized_size(h, w, side)
    if train:
        oy = int(rng.integers(0, max(nh - out_size, 0) + 1))
        ox = int(rng.integers(0, max(nw - out_size, 0) + 1))
        flip = bool(rng.integers(0, 2))
    else:
        oy, ox, flip = (max(nh - out_size, 0) // 2,
                        max(nw - out_size, 0) // 2, False)
    return nh, nw, oy, ox, flip


def crop(img: np.ndarray, geom, out_size: int) -> np.ndarray:
    """uint8 (out, out, 3) crop of an RGB uint8 image at ``geom``."""
    nh, nw, oy, ox, flip = geom
    x = torch.from_numpy(img).to(torch.float32).permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    x = x.permute(1, 2, 0)[oy:oy + out_size, ox:ox + out_size]
    if flip:
        x = x.flip(1)
    return x.round().clamp(0, 255).to(torch.uint8).numpy()


def eval_crop(data: bytes, out_size: int, resize_min: int) -> np.ndarray:
    img = decode(data)
    g = geometry(img.shape[0], img.shape[1], out_size=out_size, train=False,
                 resize_min=resize_min)
    return crop(img, g, out_size)


def train_batches(datas: list[bytes], labels, *, seed: int, steps: int,
                  batch: int, out_size: int, resize_min: int,
                  resize_max: int, shard: int = 0, shards: int = 1):
    """The first ``steps`` training batches of the records ``datas`` (with
    ``labels``), shard ``shard`` of ``shards``: ``[(uint8 (B, S, S, 3),
    int64 (B,))]``."""
    index = list(range(len(datas)))[shard::shards]
    n = len(index)
    perms = {}
    out = []
    for k0 in range(0, steps * batch, batch):
        images, labs = [], []
        for k in range(k0, k0 + batch):
            epoch, pos = divmod(k, n)
            if epoch not in perms:
                perms[epoch] = np.random.default_rng(
                    [1, seed, epoch]).permutation(n)
            rec = index[int(perms[epoch][pos])]
            rng = np.random.default_rng([2, seed, epoch, pos])
            img = decode(datas[rec])
            g = geometry(img.shape[0], img.shape[1], out_size=out_size,
                         train=True, resize_min=resize_min,
                         resize_max=resize_max, rng=rng)
            images.append(crop(img, g, out_size))
            labs.append(int(labels[rec]))
        out.append((np.stack(images), np.asarray(labs, np.int64)))
    return out
