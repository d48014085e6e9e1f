"""Scalar metrics and images to TensorBoard event files and to the log:
the port of the JAX package's ``utils/metrics_writer.py``, which writes
through CLU.  The card's machine has neither CLU nor TensorBoard, so the
event file is written by hand: TFRecord framing (``data/records.py``) of
``Event`` protos, the first carrying ``file_version``, then one a write
with ``wall_time``, ``step`` and ``summary.value``s: ``{tag,
simple_value}`` for a scalar, ``{tag, image {height, width, colorspace,
encoded_image_string}}`` for an image, PNG bytes from ``data/png.py``.
TensorBoard reads them as scalars and images; a batch of images under one
tag is written as ``<tag>/image/<i>``, as ``tf.summary.image`` did in TF1.
"""

from __future__ import annotations

import itertools
import logging
import os
import socket
import struct
import threading
import time

import numpy as np

from attentionalpoolingaction_torch.data import png
from attentionalpoolingaction_torch.data.records import (
    encode_field,
    write_framed,
)

__all__ = ["EventWriter", "make_train_hook", "make_writer", "write_eval"]

log = logging.getLogger(__name__)


def _image_value(tag: str, image: np.ndarray) -> bytes:
    """A ``Summary.Value`` {tag = 1, image = 4 {height = 1, width = 2,
    colorspace = 3 (RGB), encoded_image_string = 4}} of a uint8 (H, W, 3)
    image."""
    h, w = image.shape[:2]
    img = (encode_field(1, 0, h) + encode_field(2, 0, w)
           + encode_field(3, 0, 3) + encode_field(4, 2, png.encode(image)))
    return encode_field(1, 2, tag.encode()) + encode_field(4, 2, img)


def _event(step: int | None = None, *, file_version: str | None = None,
           scalars: dict | None = None,
           images: dict | None = None) -> bytes:
    """A serialized ``tensorflow.Event``: wall_time = 1 (double), step = 2,
    file_version = 3, summary = 5 {repeated value = 1 {tag = 1,
    simple_value = 2 (float) | image = 4}}."""
    out = encode_field(1, 1, struct.pack("<d", time.time()))
    if step is not None:
        out += encode_field(2, 0, step)
    if file_version is not None:
        out += encode_field(3, 2, file_version.encode())
    if scalars:
        values = b"".join(
            encode_field(1, 2, encode_field(1, 2, tag.encode())
                         + encode_field(2, 5, struct.pack("<f", value)))
            for tag, value in scalars.items())
        out += encode_field(5, 2, values)
    if images:
        out += encode_field(5, 2, b"".join(
            encode_field(1, 2, _image_value(tag, img))
            for tag, img in images.items()))
    return out


_file_numbers = itertools.count()


class EventWriter:
    """Scalars by step to a new event file
    ``<logdir>/events.out.tfevents.<time>.<host>.<pid>.<n>`` (unless
    ``just_logging``) and to the log."""

    def __init__(self, logdir: str, *, just_logging: bool = False):
        self.path = None
        self._file = None
        self._lock = threading.Lock()
        if not just_logging:
            os.makedirs(logdir, exist_ok=True)
            self.path = os.path.join(
                logdir, f"events.out.tfevents.{int(time.time())}."
                        f"{socket.gethostname()}.{os.getpid()}."
                        f"{next(_file_numbers)}")
            self._file = open(self.path, "wb")
            write_framed(self._file, _event(file_version="brain.Event:2"))

    def write_scalars(self, step: int, scalars: dict) -> None:
        scalars = {k: float(v) for k, v in scalars.items()}
        log.info("[%d] %s", step,
                 ", ".join(f"{k}={v:.6g}" for k, v in scalars.items()))
        if self._file is not None:
            with self._lock:
                write_framed(self._file, _event(int(step), scalars=scalars))

    def write_images(self, step: int, images: dict) -> None:
        """Image summaries by tag: a uint8 (N, H, W, 3) batch under each
        tag, PNG-encoded, one value ``<tag>/image/<i>`` an image."""
        values = {f"{tag}/image/{i}": img for tag, batch in images.items()
                  for i, img in enumerate(np.asarray(batch))}
        log.info("[%d] images %s", step, ", ".join(sorted(images)))
        if self._file is not None:
            event = _event(int(step), images=values)
            with self._lock:
                write_framed(self._file, event)

    def flush(self) -> None:
        if self._file is not None:
            with self._lock:
                self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            with self._lock:
                self._file.close()
                self._file = None


def make_writer(workdir: str, *, just_logging: bool = False) -> EventWriter:
    return EventWriter(workdir, just_logging=just_logging)


def make_train_hook(writer, log_every: int):
    """Train-loop hook: writes the step's metrics every ``log_every``
    steps."""
    def hook(step, state, metrics):
        del state
        if step % log_every == 0:
            writer.write_scalars(
                step, {k: float(v) for k, v in metrics.items()})
    return hook


def write_eval(writer, step: int, results: dict) -> None:
    scalars = {f"eval/{k}": float(v) for k, v in results.items()
               if isinstance(v, (int, float))}
    writer.write_scalars(step, scalars)
