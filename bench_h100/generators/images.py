"""Seeded JPEGs of a traffic mix.

A mix is a list of kinds, each ``{"width", "height", "gray", "share"}``;
a pool of ``n`` images holds ``round(share * n)`` of each kind (the last
kind takes the rest), so every seed gives the same sizes, in another
order and with other pixels.  A photo-like picture (a smooth colour field,
some mid-frequency texture and sensor noise, so that it compresses as a
photograph does and not as noise) is drawn from a numpy generator keyed on
``(seed, index)`` and encoded by OpenCV at the mix's quality, colour
pictures with 4:2:0 chroma.
"""

from __future__ import annotations

import cv2
import numpy as np


def kind_counts(mix: list[dict], n: int) -> list[int]:
    counts = [int(round(k["share"] * n)) for k in mix[:-1]]
    return counts + [n - sum(counts)]


def picture(rng: np.random.Generator, width: int, height: int,
            gray: bool) -> np.ndarray:
    """A photo-like uint8 (height, width, 3) or (height, width) image."""
    ch = 1 if gray else 3
    coarse = rng.uniform(0, 255, (max(height // 90, 2), max(width // 90, 2),
                                  ch)).astype(np.float32)
    img = cv2.resize(coarse, (width, height), interpolation=cv2.INTER_CUBIC)
    mid = rng.normal(0, 24, (max(height // 8, 2), max(width // 8, 2), ch))
    img = img.reshape(height, width, ch) + cv2.resize(
        mid.astype(np.float32), (width, height),
        interpolation=cv2.INTER_LINEAR).reshape(height, width, ch)
    img += rng.normal(0, 3, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def encode(img: np.ndarray, quality: int) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, int(quality)]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    ok, buf = cv2.imencode(".jpg", img, params)
    if not ok:
        raise RuntimeError("OpenCV could not encode a JPEG")
    return buf.tobytes()


def make_pool(seed: int, mix: list[dict], n: int,
              quality: int) -> list[dict]:
    """``n`` JPEGs of ``mix`` from ``seed``, in a seeded order: each
    ``{"data", "width", "height", "gray"}``."""
    kinds = []
    for k, c in zip(mix, kind_counts(mix, n)):
        kinds += [k] * c
    order = np.random.default_rng([seed, 1]).permutation(n)
    pool = []
    for i in range(n):
        k = kinds[int(order[i])]
        rng = np.random.default_rng([seed, 2, i])
        img = picture(rng, int(k["width"]), int(k["height"]),
                      bool(k.get("gray", False)))
        pool.append({"data": encode(img, quality), "width": int(k["width"]),
                     "height": int(k["height"]),
                     "gray": bool(k.get("gray", False))})
    return pool
