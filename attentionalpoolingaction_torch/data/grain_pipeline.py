"""The port's random-access input pipeline over indexed TFRecords, with
the contract of the JAX package's ``data/grain_pipeline.py``.  Grain is
not on the card's machine, so this is the port's own pipeline:

  * **train** (:func:`make_train_dataset`, :func:`make_train_iterator`):
    the record index is sliced by ``shard_index::shard_count``; each epoch
    visits every example once, in a permutation keyed on ``(seed,
    epoch)``; each example's crop and flip come from a numpy generator
    keyed on ``(seed, epoch, position)``; batches of ``batch_size`` run
    on across epoch boundaries (no remainder is ever short).  The
    iterator's JSON state is ``{"epoch", "position"}`` of the next batch
    handed out, and a resume from it is bitwise the uninterrupted stream.
    Grain's own shuffle order is not reproduced: the same seed gives
    another order than the JAX package's, with the same properties.
  * **eval** (:func:`make_eval_dataset`, :func:`make_multicrop_eval_dataset`):
    the records in file order, ``mask`` 1.0, the last batch padded with
    zero rows of ``mask`` 0.0: batch for batch the JAX package's.

Reading, parsing and drawing the geometry run on the host, in
``num_workers`` threads (0: inline), ahead of the consumer; JPEG decode
and the resize run on ``device`` when a batch is handed out
(``data/jpeg.py``, ``data/preprocessing.py``).  A batch is a dict whose
``image`` is a tensor on ``device`` ((B, S, S, 3) uint8 with
``transfer_uint8``, else float32 minus the VGG means) and whose other
features are numpy arrays, stacked as the JAX package's
``_stack_features`` stacks them.

The JAX package's default ``input_pipeline="tfdata"`` runs this same
pipeline in the port (there is no tf.data on the card's machine): its
shuffle-buffer order and its resume without state are not reproduced,
and the port always resumes exactly.  The video functions (the video
index, per-epoch frame sampling, clips) are not ported yet and raise.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator

import numpy as np
import torch

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data.datasets import DatasetSpec
from attentionalpoolingaction_torch.data.native_io import make_source
from attentionalpoolingaction_torch.data.records import parse_example
from attentionalpoolingaction_torch.device import resolve_device

__all__ = ["EvalDataset", "TrainIterator", "build_video_index",
           "make_eval_dataset", "make_multicrop_eval_dataset",
           "make_train_dataset", "make_train_iterator",
           "make_video_clip_eval_dataset", "make_video_train_dataset",
           "parse_example"]

# domain tags of the generators' keys: numpy's SeedSequence pads a short
# key with zeros, so (seed, epoch) and (seed, epoch, 0) would collide
_PERMUTATION, _GEOMETRY = 1, 2
_READ_AHEAD = 2         # batches the reader threads prepare ahead


def _prepare(raw: bytes, spec: DatasetSpec, rng, *, image_size: int,
             is_training: bool, resize_min: int, resize_max: int | None,
             include_anno: bool = False, num_crops: int = 0) -> dict:
    """Host half of one example: parsed features, the JPEG bytes and the
    crop geometry (or ``num_crops`` multicrop geometries)."""
    parsed = parse_example(raw, spec, include_anno=include_anno)
    data = parsed.pop("image_bytes")
    h, w = jpeg.image_size(data)
    if num_crops:
        geoms = pp.multicrop_geometry(h, w, out_size=image_size,
                                      resize_min=resize_min,
                                      num_crops=num_crops)
        return {"image_bytes": data, "geometry": geoms, **parsed}
    g = pp.draw_geometry(h, w, out_size=image_size, is_training=is_training,
                         resize_min=resize_min, resize_max=resize_max,
                         rng=rng)
    return {"image_bytes": data, "geometry": g, "transform": g.transform(),
            **parsed}


def _materialize(examples: list[dict], device: torch.device, *,
                 image_size: int, keep_uint8: bool) -> dict:
    """Device half of a batch: decode, resize, crop and flip each image on
    ``device`` and stack; the other features are stacked numpy arrays."""
    images = jpeg.decode([e["image_bytes"] for e in examples], device)
    crops = []
    for img, e in zip(images, examples):
        g = e["geometry"]
        crops.append(pp.apply_multicrop(img, g, out_size=image_size)
                     if isinstance(g, list) else
                     pp.apply_geometry(img, g, out_size=image_size,
                                       keep_uint8=keep_uint8))
    batch = {"image": torch.stack(crops)}
    for k in examples[0]:
        if k not in ("image_bytes", "geometry"):
            batch[k] = np.stack([np.asarray(e[k]) for e in examples])
    return batch


def _pad_batch(batch: dict, batch_size: int) -> dict:
    """Zero rows up to ``batch_size`` (``mask`` 0 there)."""
    n = len(batch["mask"])
    if n == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.cat([v, v.new_zeros((batch_size - n,)
                                               + tuple(v.shape[1:]))])
        else:
            out[k] = np.pad(v, [(0, batch_size - n)]
                            + [(0, 0)] * (v.ndim - 1))
    return out


class TrainIterator:
    """Infinite train batches with the Grain contract above; see the
    module docstring.  With ``num_workers`` > 0, two batches are read,
    parsed and given their geometry ahead of the consumer."""

    def __init__(self, source, spec: DatasetSpec, *, batch_size: int,
                 image_size: int, resize_min: int, resize_max: int,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 transfer_uint8: bool = False, num_workers: int = 0,
                 device=None):
        self._src, self._spec = source, spec
        self._index = np.arange(len(source))[shard_index::shard_count]
        if len(self._index) == 0:
            raise ValueError(f"shard {shard_index} of {shard_count} of "
                             f"{len(source)} records is empty")
        self._batch_size, self._image_size = batch_size, image_size
        self._resize = (resize_min, resize_max)
        self._seed, self._keep_uint8 = seed, transfer_uint8
        self._device = resolve_device(device)
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            num_workers, thread_name_prefix="train-input")
            if num_workers else None)
        self._perms: dict[int, np.ndarray] = {}
        self._next = 0          # stream position of the next batch out
        self._ahead = 0         # stream position of the next batch read
        self._pending: collections.deque = collections.deque()

    def _coords(self, k: int) -> tuple[int, int, int]:
        """(epoch, position, record index) of stream position ``k``."""
        n = len(self._index)
        epoch, pos = divmod(k, n)
        if epoch not in self._perms:
            for old in [e for e in self._perms if e < epoch - 1]:
                del self._perms[old]
            self._perms[epoch] = np.random.default_rng(
                [_PERMUTATION, self._seed, epoch]).permutation(n)
        return epoch, pos, int(self._index[self._perms[epoch][pos]])

    def _example(self, epoch: int, pos: int, index: int) -> dict:
        rng = np.random.default_rng([_GEOMETRY, self._seed, epoch, pos])
        return _prepare(self._src[index], self._spec, rng,
                        image_size=self._image_size, is_training=True,
                        resize_min=self._resize[0],
                        resize_max=self._resize[1])

    def _read(self, k: int) -> list:
        coords = [self._coords(k + i) for i in range(self._batch_size)]
        if self._pool is None:
            return [self._example(*c) for c in coords]
        return [self._pool.submit(self._example, *c) for c in coords]

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._pool is None:
            examples = self._read(self._next)
        else:
            while len(self._pending) < _READ_AHEAD:
                self._pending.append(self._read(self._ahead))
                self._ahead += self._batch_size
            examples = [f.result() for f in self._pending.popleft()]
        self._next += self._batch_size
        return _materialize(examples, self._device,
                            image_size=self._image_size,
                            keep_uint8=self._keep_uint8)

    def get_state(self) -> dict:
        epoch, pos = divmod(self._next, len(self._index))
        return {"epoch": epoch, "position": pos}

    def set_state(self, state: dict) -> None:
        for futures in self._pending:
            for f in futures:
                f.cancel()
        self._pending.clear()
        self._next = self._ahead = (int(state["epoch"]) * len(self._index)
                                    + int(state["position"]))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def _resolved(image_size, resize_min, resize_max):
    resize_min = resize_min or image_size
    return resize_min, resize_max or int(resize_min * 512 / 256)


def make_train_dataset(pattern, spec: DatasetSpec, *, batch_size: int,
                       image_size: int, resize_min: int | None = None,
                       resize_max: int | None = None, seed: int = 0,
                       shard_index: int = 0, shard_count: int = 1,
                       transfer_uint8: bool = False, num_workers: int = 0,
                       device=None) -> TrainIterator:
    """The infinite shuffled train stream of batched feature dicts (per
    host batch) over the records of ``pattern``."""
    resize_min, resize_max = _resolved(image_size, resize_min, resize_max)
    return TrainIterator(
        make_source(pattern), spec, batch_size=batch_size,
        image_size=image_size, resize_min=resize_min, resize_max=resize_max,
        seed=seed, shard_index=shard_index, shard_count=shard_count,
        transfer_uint8=transfer_uint8, num_workers=num_workers,
        device=device)


def make_train_iterator(pattern, spec: DatasetSpec, *, num_workers: int = 0,
                        video_sampling: bool = False, **kw) -> TrainIterator:
    """The train stream with ``num_workers`` host threads reading ahead.
    ``video_sampling`` (per-epoch frame sampling of HMDB51) is not ported
    yet and raises."""
    if video_sampling:
        raise NotImplementedError(
            "video frame sampling (make_video_train_dataset) is not ported "
            "yet; set video_frame_sampling=False to iterate the frames")
    return make_train_dataset(pattern, spec, num_workers=num_workers, **kw)


class EvalDataset:
    """One pass over the records in file order, re-iterable: batches of
    ``batch_size`` with ``mask`` 1.0, the last one padded (``mask`` 0)."""

    def __init__(self, source, spec: DatasetSpec, *, batch_size: int,
                 image_size: int, resize_min: int, num_crops: int = 0,
                 transfer_uint8: bool = False, pad_to_batch: bool = True,
                 shard_index: int = 0, shard_count: int = 1, device=None):
        self._src, self._spec = source, spec
        self._index = range(len(source))[shard_index::shard_count]
        self._batch_size, self._image_size = batch_size, image_size
        self._resize_min, self._num_crops = resize_min, num_crops
        self._keep_uint8, self._pad = transfer_uint8, pad_to_batch
        self._device = resolve_device(device)

    def __len__(self) -> int:
        return -(-len(self._index) // self._batch_size)

    def __iter__(self) -> Iterator[dict]:
        for lo in range(0, len(self._index), self._batch_size):
            examples = []
            for i in self._index[lo:lo + self._batch_size]:
                e = _prepare(self._src[i], self._spec, None,
                             image_size=self._image_size, is_training=False,
                             resize_min=self._resize_min, resize_max=None,
                             include_anno=self._spec.multi_label,
                             num_crops=self._num_crops)
                e["mask"] = np.float32(1.0)
                examples.append(e)
            batch = _materialize(examples, self._device,
                                 image_size=self._image_size,
                                 keep_uint8=self._keep_uint8)
            yield _pad_batch(batch, self._batch_size) if self._pad else batch


def make_eval_dataset(pattern, spec: DatasetSpec, *, batch_size: int,
                      image_size: int, resize_min: int | None = None,
                      pad_to_batch: bool = True, shard_index: int = 0,
                      shard_count: int = 1, transfer_uint8: bool = False,
                      device=None) -> EvalDataset:
    """One-pass eval batches of the central crop, the last one padded.
    Images are float32 minus the VGG means as in the JAX package's Grain
    eval; ``transfer_uint8`` keeps them uint8 (its tf.data eval)."""
    return EvalDataset(
        make_source(pattern), spec, batch_size=batch_size,
        image_size=image_size, resize_min=resize_min or image_size,
        transfer_uint8=transfer_uint8, pad_to_batch=pad_to_batch,
        shard_index=shard_index, shard_count=shard_count, device=device)


def make_multicrop_eval_dataset(pattern, spec: DatasetSpec, *,
                                batch_size: int, image_size: int,
                                resize_min: int, num_crops: int = 3,
                                pad_to_batch: bool = True,
                                shard_index: int = 0, shard_count: int = 1,
                                device=None) -> EvalDataset:
    """One-pass eval batches of (num_crops, S, S, 3) float32 crops an
    example (``eval_multicrop_np``'s geometry)."""
    return EvalDataset(
        make_source(pattern), spec, batch_size=batch_size,
        image_size=image_size, resize_min=resize_min, num_crops=num_crops,
        pad_to_batch=pad_to_batch, shard_index=shard_index,
        shard_count=shard_count, device=device)


def _video_not_ported(*args, **kwargs):
    raise NotImplementedError(
        "the video input path (video index, per-epoch frame sampling, "
        "clips) is not ported yet")


build_video_index = _video_not_ported
make_video_train_dataset = _video_not_ported
make_video_clip_eval_dataset = _video_not_ported
