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
    A state of the JAX package's Grain iterator resumes after the same
    count of records (:func:`grain_batches`).  Grain's own shuffle order
    is not reproduced: the same seed gives another order than the JAX
    package's, with the same properties.
  * **video train** (:func:`make_video_train_dataset`): the items are
    the videos of :func:`build_video_index` (its ``<file>.vidx.json``
    sidecar is the JAX package's, so either package reads the other's),
    in the same per-epoch permutation: each epoch visits every video once
    and draws one random frame of it, or with ``clip_frames`` > 1 a TSN
    clip of one frame a segment (:func:`_segment_picks`) sharing one
    geometry, from the example's generator as the JAX package draws them.
  * **eval** (:func:`make_eval_dataset`, :func:`make_multicrop_eval_dataset`,
    :func:`make_video_clip_eval_dataset`): the records (or the videos'
    clips and crops) in the JAX package's order, ``mask`` 1.0, the last
    batch padded with zero rows of ``mask`` 0.0: batch for batch the JAX
    package's.

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
and the port always resumes exactly.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import pathlib
from typing import Iterator, Sequence

import numpy as np
import torch

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data.datasets import DatasetSpec
from attentionalpoolingaction_torch.data.native_io import make_source
from attentionalpoolingaction_torch.data.records import (
    decode_example,
    parse_example,
)
from attentionalpoolingaction_torch.device import resolve_device

__all__ = ["ClipEvalDataset", "EvalDataset", "TrainIterator",
           "build_video_index", "grain_batches", "make_eval_dataset",
           "make_multicrop_eval_dataset",
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


def _prepare_clip(raws: Sequence[bytes], spec: DatasetSpec, rng, *,
                  image_size: int, is_training: bool, resize_min: int,
                  resize_max: int | None,
                  crop_frac: float | None = None) -> dict:
    """Host half of one clip of a video (``_clip_features``): the frames'
    JPEG bytes, one geometry drawn from the first frame's size, and the
    label and ``video_id`` of the first frame."""
    parsed = [parse_example(r, spec) for r in raws]
    h, w = jpeg.image_size(parsed[0]["image_bytes"])
    g = pp.draw_geometry(h, w, out_size=image_size, is_training=is_training,
                         resize_min=resize_min, resize_max=resize_max,
                         rng=rng, crop_frac=crop_frac)
    return {"image_bytes": [p["image_bytes"] for p in parsed],
            "geometry": g, "transform": g.transform(),
            "label": parsed[0]["label"], "video_id": parsed[0]["video_id"],
            "frame": np.asarray([p["frame"] for p in parsed], np.int32)}


def _materialize(examples: list[dict], device: torch.device, *,
                 image_size: int, keep_uint8: bool) -> dict:
    """Device half of a batch: decode, resize, crop and flip each image
    (each frame of a clip) on ``device`` and stack; the other features are
    stacked numpy arrays."""
    spans, datas = [], []
    for e in examples:
        data = e["image_bytes"]
        frames = data if isinstance(data, list) else [data]
        spans.append(slice(len(datas), len(datas) + len(frames)))
        datas.extend(frames)
    images = jpeg.decode(datas, device)
    crops = []
    for span, e in zip(spans, examples):
        g = e["geometry"]
        if isinstance(e["image_bytes"], list):
            crops.append(pp.apply_clip(images[span], g, out_size=image_size,
                                       keep_uint8=keep_uint8))
        elif isinstance(g, list):
            crops.append(pp.apply_multicrop(images[span.start], g,
                                            out_size=image_size))
        else:
            crops.append(pp.apply_geometry(images[span.start], g,
                                           out_size=image_size,
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
    module docstring.  The items are the records, or with ``videos`` (a
    list of each video's record indices) the videos, with one random frame
    or a TSN clip of ``clip_frames`` drawn from each.  With
    ``num_workers`` > 0, two batches are read, parsed and given their
    geometry ahead of the consumer."""

    def __init__(self, source, spec: DatasetSpec, *, batch_size: int,
                 image_size: int, resize_min: int, resize_max: int,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 transfer_uint8: bool = False, num_workers: int = 0,
                 videos: list[list[int]] | None = None, clip_frames: int = 1,
                 device=None):
        self._src, self._spec = source, spec
        items = range(len(source)) if videos is None else videos
        self._index = items[shard_index::shard_count]
        self._videos, self._clip_frames = videos is not None, clip_frames
        if len(self._index) == 0:
            raise ValueError(f"shard {shard_index} of {shard_count} of "
                             f"{len(items)} items is empty")
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

    def _coords(self, k: int) -> tuple[int, int, object]:
        """(epoch, position, item) of stream position ``k``: a record index,
        or a video's record indices."""
        n = len(self._index)
        epoch, pos = divmod(k, n)
        if epoch not in self._perms:
            for old in [e for e in self._perms if e < epoch - 1]:
                del self._perms[old]
            self._perms[epoch] = np.random.default_rng(
                [_PERMUTATION, self._seed, epoch]).permutation(n)
        return epoch, pos, self._index[int(self._perms[epoch][pos])]

    def _example(self, epoch: int, pos: int, item) -> dict:
        """One example from its generator, drawing as the JAX package's
        ``make_video_train_dataset.sample`` draws: the frame (or the
        clip's picks) first, then the geometry."""
        rng = np.random.default_rng([_GEOMETRY, self._seed, epoch, pos])
        kw = dict(image_size=self._image_size, is_training=True,
                  resize_min=self._resize[0], resize_max=self._resize[1])
        if not self._videos:
            return _prepare(self._src[item], self._spec, rng, **kw)
        if self._clip_frames > 1:
            picks = _segment_picks(len(item), self._clip_frames, rng)
            return _prepare_clip([self._src[item[p]] for p in picks],
                                 self._spec, rng, **kw)
        return _prepare(self._src[item[int(rng.integers(len(item)))]],
                        self._spec, rng, **kw)

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
        """Resume at ``state``: the port's ``{"epoch", "position"}``, or
        the state of the JAX package's Grain iterator, which counts
        batches (:func:`grain_batches`): the stream then resumes after as
        many records, at that epoch and position of the port's order."""
        for futures in self._pending:
            for f in futures:
                f.cancel()
        self._pending.clear()
        if "epoch" in state:
            k = (int(state["epoch"]) * len(self._index)
                 + int(state["position"]))
        else:
            k = grain_batches(state) * self._batch_size
        self._next = self._ahead = k

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)


def grain_batches(state: dict) -> int:
    """The batches that the JAX package's Grain train iterator had handed
    out at ``state``: ``next_index`` (one process, no workers), or, with
    ``grain_workers``, each worker's ``next_index`` plus its
    ``iterations_to_skip``.  Another state raises ``ValueError``."""
    if set(state) == {"next_index"}:
        return int(state["next_index"])
    if {"workers_state", "iterations_to_skip"} <= set(state):
        return (sum(int(w["next_index"])
                    for w in state["workers_state"].values())
                + sum(int(v) for v in state["iterations_to_skip"].values()))
    raise ValueError(f"an iterator state with keys {sorted(state)} is "
                     "neither the port's nor Grain's (a tf.data state, "
                     "tfdata_ckpt, is not resumed)")


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
    ``video_sampling`` switches to the videos of the video index, with
    per-epoch frame sampling (the HMDB51 protocol; ``clip_frames`` passes
    through)."""
    maker = make_video_train_dataset if video_sampling else (
        make_train_dataset)
    return maker(pattern, spec, num_workers=num_workers, **kw)


class EvalDataset:
    """One pass over the records in file order, re-iterable: batches of
    ``batch_size`` with ``mask`` 1.0, the last one padded (``mask`` 0)."""

    def __init__(self, source, spec: DatasetSpec, *, batch_size: int,
                 image_size: int, resize_min: int, num_crops: int = 0,
                 transfer_uint8: bool = False, pad_to_batch: bool = True,
                 shard_index: int = 0, shard_count: int = 1, device=None):
        self._src, self._spec = source, spec
        self._index = self._items()[shard_index::shard_count]
        self._batch_size, self._image_size = batch_size, image_size
        self._resize_min, self._num_crops = resize_min, num_crops
        self._keep_uint8, self._pad = transfer_uint8, pad_to_batch
        self._device = resolve_device(device)

    def _items(self) -> Sequence:
        return range(len(self._src))

    def _example(self, i) -> dict:
        return _prepare(self._src[i], self._spec, None,
                        image_size=self._image_size, is_training=False,
                        resize_min=self._resize_min, resize_max=None,
                        include_anno=self._spec.multi_label,
                        num_crops=self._num_crops)

    def __len__(self) -> int:
        return -(-len(self._index) // self._batch_size)

    def __iter__(self) -> Iterator[dict]:
        for lo in range(0, len(self._index), self._batch_size):
            examples = []
            for item in self._index[lo:lo + self._batch_size]:
                e = self._example(item)
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


class ClipEvalDataset(EvalDataset):
    """One pass over ``num_clips`` x ``num_crops`` clip rows a video, in
    the JAX package's row order; see
    :func:`make_video_clip_eval_dataset`."""

    def __init__(self, source, spec: DatasetSpec, *, clip_frames: int,
                 num_clips: int, num_crops: int, **kw):
        self._clip_frames = clip_frames
        self._num_clips, self._clip_crops = num_clips, max(num_crops, 1)
        super().__init__(source, spec, **kw)

    def _items(self) -> list:
        by_vid = build_video_index(self._src, self._spec)
        return [(by_vid[v], k, j) for v in sorted(by_vid)
                for k in range(self._num_clips)
                for j in range(self._clip_crops)]

    def _example(self, row) -> dict:
        frame_idxs, k, j = row
        picks = _segment_picks(len(frame_idxs), self._clip_frames,
                               frac=(k + 0.5) / self._num_clips)
        return _prepare_clip(
            [self._src[frame_idxs[p]] for p in picks], self._spec, None,
            image_size=self._image_size, is_training=False,
            resize_min=self._resize_min, resize_max=None,
            crop_frac=(None if self._clip_crops == 1
                       else j / (self._clip_crops - 1)))


def _record_video_ids(read_record, n: int) -> list[int]:
    """``video/id`` of each of ``n`` records (a decode of the record, done
    once a file, then kept in the ``.vidx.json`` sidecar)."""
    return [int(decode_example(read_record(i))["video/id"][0])
            for i in range(n)]


def _file_video_ids(f) -> list[int]:
    """Per-record video ids of one indexed TFRecord file, kept in a
    ``<file>.vidx.json`` sidecar keyed by ``[st_size, st_mtime_ns]``: the
    JAX package's format, so either package reads the other's; a stale
    key rebuilds it."""
    sidecar = pathlib.Path(f.tfrecord_path + ".vidx.json")
    st = os.stat(f.tfrecord_path)
    key = [int(st.st_size), int(st.st_mtime_ns)]
    if sidecar.exists():
        try:
            cached = json.loads(sidecar.read_text())
            if cached.get("key") == key:
                return cached["video_ids"]
        except (ValueError, KeyError, OSError):
            pass
    ids = _record_video_ids(lambda i: f[i], len(f))
    try:
        sidecar.write_text(json.dumps({"key": key, "video_ids": ids}))
    except OSError:
        pass    # a read-only dataset: rebuilt in memory at each start
    return ids


def build_video_index(src, spec: DatasetSpec) -> dict[int, list[int]]:
    """The record indices of each video id, in record order: one scan of
    the source, kept in a sidecar a file.  HMDB51 records hold one frame
    each; per-epoch frame sampling draws from a video's records."""
    del spec    # the schema is fixed: video/id int64
    by_vid: dict[int, list[int]] = {}
    i = 0
    for f in getattr(src, "files", None) or []:
        for vid in _file_video_ids(f):
            by_vid.setdefault(vid, []).append(i)
            i += 1
    if i == 0:  # a source without files: a direct scan
        for vid in _record_video_ids(lambda j: src[j], len(src)):
            by_vid.setdefault(vid, []).append(i)
            i += 1
    return by_vid


def _segment_picks(n: int, clip_frames: int, rng=None,
                   frac: float = 0.5) -> list[int]:
    """TSN sampling of ``n`` frames: ``clip_frames`` equal segments, one
    frame from each: a random one with ``rng`` (training), else the one at
    fraction ``frac`` of the segment (eval).  A video shorter than the
    clip repeats frames.  The JAX package's function, draw for draw."""
    bounds = np.linspace(0, n, clip_frames + 1)
    picks = []
    for i in range(clip_frames):
        lo, hi = int(bounds[i]), max(int(bounds[i + 1]), int(bounds[i]) + 1)
        hi = min(hi, n)
        if hi <= lo:
            lo = hi - 1
        picks.append(int(rng.integers(lo, hi)) if rng is not None
                     else min(lo + int(frac * (hi - lo)), hi - 1))
    return picks


def make_video_train_dataset(pattern, spec: DatasetSpec, *, batch_size: int,
                             image_size: int, resize_min: int | None = None,
                             resize_max: int | None = None, seed: int = 0,
                             shard_index: int = 0, shard_count: int = 1,
                             transfer_uint8: bool = False,
                             clip_frames: int = 1, num_workers: int = 0,
                             device=None) -> TrainIterator:
    """The infinite video-level train stream: each epoch visits every
    video of the index once, in a fresh permutation keyed on (seed,
    epoch), and draws one random frame of it (``clip_frames`` 1, the
    HMDB51 protocol) or a temporally ordered (T, S, S, 3) clip of one
    random frame from each of T equal segments, all sharing one geometry.
    The order differs from the JAX package's Grain shuffle; the
    properties are the same."""
    resize_min, resize_max = _resolved(image_size, resize_min, resize_max)
    src = make_source(pattern)
    by_vid = build_video_index(src, spec)
    return TrainIterator(
        src, spec, batch_size=batch_size, image_size=image_size,
        resize_min=resize_min, resize_max=resize_max, seed=seed,
        shard_index=shard_index, shard_count=shard_count,
        transfer_uint8=transfer_uint8, num_workers=num_workers,
        videos=[by_vid[v] for v in sorted(by_vid)], clip_frames=clip_frames,
        device=device)


def make_video_clip_eval_dataset(pattern, spec: DatasetSpec, *,
                                 batch_size: int, image_size: int,
                                 resize_min: int | None = None,
                                 clip_frames: int = 8, num_clips: int = 1,
                                 num_crops: int = 1,
                                 pad_to_batch: bool = True,
                                 shard_index: int = 0, shard_count: int = 1,
                                 device=None) -> ClipEvalDataset:
    """One pass of ``num_clips`` x ``num_crops`` deterministic float32
    (clip_frames, S, S, 3) clips a video, the videos by id: clip k picks
    each segment's frame at fraction (k + 0.5) / num_clips, crop j sits
    at fraction j / (num_crops - 1) of the spare extent (the central crop
    for one).  The rows share the video's ``video_id``, so the per-video
    averaging of the eval combines them."""
    return ClipEvalDataset(
        make_source(pattern), spec, clip_frames=clip_frames,
        num_clips=num_clips, num_crops=num_crops, batch_size=batch_size,
        image_size=image_size, resize_min=resize_min or image_size,
        pad_to_batch=pad_to_batch, shard_index=shard_index,
        shard_count=shard_count, device=device)
