"""Online serving: bucketed-batch predictor + dynamic request batching.
Port of the JAX package's ``serving.py``.

  * **Shape bucketing.** Requests are padded up to the next batch bucket
    (default 1/8/32/128); ``warmup()`` runs every bucket once so that cuDNN
    picks its algorithms and the kernels are built before the first
    request.
  * **Dynamic batching.** ``DynamicBatcher`` coalesces concurrent requests
    into one device dispatch (bounded wait).
  * **Precision.** The float model (the ActionModel in eval mode), or with
    ``int8`` the BN-folded post-training-quantized forward
    (``models/inference.py``) in bfloat16 activations.
  * **Bytes in.** :meth:`BucketedPredictor.preprocess` decodes a request's
    bytes on the predictor's device (a JPEG by nvJPEG on a card, OpenCV on
    the CPU; a PNG on the host by ``data/png.py``, then uploaded) and
    crops it at the eval geometry of ``data/preprocessing.py``; the uint8
    crop stays on the device up to the forward.  Video clips come as
    ordered frames or as one container (OpenCV, where it is installed).
  * **Data parallelism.** With ``data_parallel`` and more than one local
    card, one replica of the weights a card: buckets round up to multiples
    of the replicas, a bucket splits evenly over them, and the logits are
    gathered to the host.  With one card (or the flag off) it is
    single-device dispatch, as JAX's rule is.  This is the one place
    where a process drives several cards.  Replicas on cards replay CUDA
    graphs (:class:`_ReplicaGraph`): one launch a replica and call, where
    eager dispatch costs the host ~400 launches a replica.

The ``Predictor`` is built from Flax-layout (params, batch_stats) arrays
through the weight bridge (``convert.py``); ``load_predictor`` builds one
from a checkpoint of the port (the latest step, a step, or the keep-best
slot), and ``CheckpointFollower`` hot-swaps newer steps into it;
``export.py`` serves an exported artifact through the same
``BucketedPredictor``.
"""

from __future__ import annotations

import logging
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch.convert import load_flax_variables
from attentionalpoolingaction_torch.data import jpeg, png
from attentionalpoolingaction_torch.data import preprocessing as pp
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.data.grain_pipeline import _segment_picks
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.models import inference as inf
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc
from attentionalpoolingaction_torch.train import build_model, normalize_images

DEFAULT_BUCKETS = (1, 8, 32, 128)
NO_CLIP_FORWARD = ("this predictor has no clip forward (the artifact was "
                   "exported per-image); re-export with "
                   "export_predictor(include_clip=True) / a clip_frames>1 "
                   "config, or serve from the checkpoint")

log = logging.getLogger(__name__)


def as_device_tensor(images, device) -> torch.Tensor:
    """A batch of images (a numpy array or a tensor) as a tensor on
    ``device``."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    return images.to(device)


class Overloaded(RuntimeError):
    """The DynamicBatcher's bounded queue is full: the server is taking
    requests faster than the device drains them.  Raised synchronously by
    submit() so the HTTP layer can answer 429 + Retry-After at once."""


def decode_image(data: bytes, device) -> torch.Tensor:
    """RGB uint8 (H, W, 3) of a request's image bytes on ``device``, told
    apart by their magic bytes: a JPEG by ``data/jpeg.py`` (nvJPEG on a
    card, OpenCV on the CPU), a PNG by ``data/png.py`` on the host, then
    uploaded.  Anything else raises ``ValueError``."""
    data = bytes(data)
    if png.is_png(data):
        return torch.from_numpy(png.decode(data)).to(device)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode([data], device)[0]
    raise ValueError("not a JPEG or PNG stream")


def crop_decoded(decoded, cfg: config_lib.TrainConfig, device, *,
                 keep_uint8: bool = True) -> torch.Tensor:
    """The eval crop of a decoded RGB uint8 (H, W, 3) image (a tensor, or
    an array that is uploaded to ``device``): the short side to
    ``resize_min``, the central ``image_size`` square, uint8 with
    ``keep_uint8``, else float32 minus the VGG means."""
    if not isinstance(decoded, torch.Tensor):
        decoded = torch.from_numpy(np.ascontiguousarray(decoded))
    decoded = decoded.to(device)
    h, w = decoded.shape[:2]
    g = pp.draw_geometry(h, w, out_size=cfg.image_size, is_training=False,
                         resize_min=cfg.resize_min_resolved)
    return pp.apply_geometry(decoded, g, out_size=cfg.image_size,
                             keep_uint8=keep_uint8)


def decode_video_frames(data: bytes, clip_frames: int):
    """The ``clip_frames`` TSN segment-centre frames of an encoded video
    container as RGB uint8 arrays, and the container's frame count, read
    by OpenCV in one pass that grabs past the frames it does not pick (the
    JAX package's function).  Raises ``ValueError`` where OpenCV is not
    installed, or the bytes are no video."""
    import os
    import tempfile

    try:
        import cv2
    except ImportError:
        raise ValueError("decoding a video container needs OpenCV (cv2), "
                         "which is not installed; send the ordered frames "
                         "as JSON {\"frames\": [...]} instead") from None

    with tempfile.NamedTemporaryFile(suffix=".video", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise ValueError("not a decodable video container")
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if n <= 0:  # unreliable metadata: count by grabbing
                while cap.grab():
                    n += 1
                cap.release()
                cap = cv2.VideoCapture(path)
            if n <= 0:
                raise ValueError("video has no frames")
            picks = _segment_picks(n, clip_frames)
            want = set(picks)
            by_idx: dict[int, np.ndarray] = {}
            for idx in range(max(picks) + 1):
                if idx in want:
                    ok, fr = cap.read()
                    if not ok:
                        raise ValueError(
                            f"decode failed at frame {idx}/{n}")
                    by_idx[idx] = cv2.cvtColor(fr, cv2.COLOR_BGR2RGB)
                elif not cap.grab():
                    raise ValueError(f"decode failed at frame {idx}/{n}")
            return [by_idx[p] for p in picks], n
        finally:
            cap.release()
    finally:
        os.unlink(path)


# Prometheus-style cumulative histogram bounds for request latency;
# spans sub-ms (cache-warm small batches) to the 60s handler timeout
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class ServingStats:
    """Thread-safe serving counters + latency histograms, rendered as
    Prometheus text: request outcomes, device dispatches and their wall
    time, coalesced batch sizes, padding waste, and request latency."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c: dict[str, float] = {}
        self._h: dict[str, list] = {}   # name -> [counts per bucket, sum]
        self._g: dict[str, float] = {}  # gauges (e.g. queue depth)

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._c[name] = self._c.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._g[name] = float(value)

    def gauges(self) -> dict:
        with self._lock:
            return dict(self._g)

    def observe_dispatch(self, real: int, padded: int, seconds: float):
        self.inc("serving_device_dispatches_total")
        self.inc("serving_device_seconds_sum", seconds)
        self.inc("serving_items_total", real)
        self.inc("serving_padded_items_total", padded - real)

    def observe_latency(self, seconds: float,
                        name: str = "serving_latency_seconds"):
        """Record one observation into the cumulative-bucket histogram."""
        with self._lock:
            if name not in self._h:
                self._h[name] = [[0] * (len(LATENCY_BUCKETS) + 1), 0.0]
            counts, _ = self._h[name]
            for i, le in enumerate(LATENCY_BUCKETS):
                if seconds <= le:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1          # +Inf bucket
            self._h[name][1] += seconds

    def latency_quantile(self, q: float,
                         name: str = "serving_latency_seconds") -> float:
        """Histogram-interpolated quantile (what PromQL's
        histogram_quantile computes)."""
        with self._lock:
            if name not in self._h:
                return float("nan")
            counts = list(self._h[name][0])
        total = sum(counts)
        if not total:
            return float("nan")
        rank = q * total
        cum = 0
        lo = 0.0
        for i, le in enumerate(LATENCY_BUCKETS):
            if cum + counts[i] >= rank:
                # linear interpolation within the bucket
                frac = (rank - cum) / max(counts[i], 1)
                return lo + (le - lo) * frac
            cum += counts[i]
            lo = le
        return LATENCY_BUCKETS[-1]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._c)

    def render(self) -> str:
        lines = []
        for name, v in sorted(self.snapshot().items()):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {v:g}")
        for name, v in sorted(self.gauges().items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v:g}")
        with self._lock:
            hists = {k: (list(v[0]), v[1]) for k, v in self._h.items()}
        for name, (counts, total_s) in sorted(hists.items()):
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for i, le in enumerate(LATENCY_BUCKETS):
                cum += counts[i]
                lines.append(f'{name}_bucket{{le="{le:g}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{name}_sum {total_s:g}")
            lines.append(f"{name}_count {cum}")
        return "\n".join(lines) + "\n"


class _ReplicaGraph:
    """The forward of one replica at one input shape and dtype, captured
    as a CUDA graph on the replica's stream, with its static input and
    output, pinned host buffers and an event.  ``weights`` are the ones
    captured (kept alive with the graph, which reads them in place).

    A replay passes through no kernel wrapper, so the launches that the
    capture recorded (``apc.recording_launches``) are added to the
    counters at each replay; the capture itself counts none, and the eager
    warm-up before it counts as the launches it makes.  A graph keeps the
    backend settings (TF32) in force when it was captured."""

    def __init__(self, predictor, weights, device: torch.device, shape,
                 dtype: torch.dtype, stream, pool):
        self.weights, self.device, self.stream = weights, device, stream
        self.input = torch.zeros(shape, dtype=dtype, device=device)
        self.host_in = None         # pinned, made for the first host input
        with torch.cuda.device(device):
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                # eager first: builds the kernels, picks cuDNN's algorithms
                # and fills the heads' caches outside the graph
                predictor.logits(weights, self.input, device=device)
            self.graph = torch.cuda.CUDAGraph()
            with apc.recording_launches() as self.launches, \
                    torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                     capture_error_mode="thread_local"):
                self.output = predictor.logits(weights, self.input,
                                               device=device)
        self.host_out = torch.empty(self.output.shape, dtype=torch.float32,
                                    pin_memory=True)
        self.done = torch.cuda.Event()

    def launch(self, part) -> None:
        """Copy ``part`` (a host array or a tensor on any card) into the
        static input, replay, and queue the copy of the logits to the
        host, all on the replica's stream."""
        stream = self.stream
        if isinstance(part, torch.Tensor):
            stream.wait_stream(torch.cuda.current_stream(part.device))
        else:
            if self.host_in is None:
                self.host_in = torch.empty_like(self.input, device="cpu",
                                                pin_memory=True)
            self.host_in.numpy()[...] = part
            part = self.host_in
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            self.input.copy_(part, non_blocking=True)
            self.graph.replay()
            self.host_out.copy_(self.output, non_blocking=True)
            self.done.record(stream)
        apc.add_launches(self.launches)

    def read(self) -> np.ndarray:
        self.done.synchronize()
        return self.host_out.numpy().copy()


class BucketedPredictor:
    """Shape-bucketed padded batch inference over a forward fn, and the
    byte path in front of it.

    Subclass ``__init__`` must set ``cfg``, ``spec``, ``int8``, ``device``,
    ``stats``, ``buckets`` (through :meth:`_init_data_parallel`),
    ``_weights`` (one set a replica when there are replicas) and
    ``logits(weights, images, device=None)`` (float32 logits on
    ``device``, default ``self.device``, of (B, H, W, 3) images, numpy or
    tensors, and where ``supports_clips`` of (1, T, H, W, 3) clips)."""

    cfg: config_lib.TrainConfig
    buckets: tuple
    supports_clips = False
    # the devices of the data-parallel replicas; empty: one device
    replicas: tuple = ()
    # replicas on cards: each replica's captured forwards, by (replica,
    # input shape, dtype); None where dispatch is eager
    _replica_graphs: dict | None = None

    def _init_data_parallel(self, data_parallel: bool, buckets,
                            devices=None) -> tuple:
        """The data-parallel recipe of JAX's ``_init_data_parallel``:
        with ``data_parallel`` and more than one device (``devices``,
        default every local card of the predictor's device type), buckets
        round UP to multiples of the device count and
        :attr:`replicas` lists the devices; otherwise single-device
        dispatch.  Replicas on cards run through CUDA graphs (a stream
        and a memory pool each).  Returns the buckets."""
        self.replicas = ()
        self._replica_graphs = None
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        if not (data_parallel and len(devices) > 1):
            return tuple(sorted(set(int(b) for b in buckets)))
        n = len(devices)
        self.replicas = tuple(torch.device(d) for d in devices)
        if all(d.type == "cuda" for d in self.replicas):
            self._replica_graphs = {}
            self._graph_lock = threading.Lock()
            self._streams, self._pools = [], []
            for d in self.replicas:
                with torch.cuda.device(d):
                    self._streams.append(torch.cuda.Stream(d))
                    self._pools.append(torch.cuda.graph_pool_handle())
        return tuple(sorted({-(-int(b) // n) * n for b in buckets}))

    def _fwd(self, weights, images) -> np.ndarray:
        """(B, C) float32 host logits; with replicas, the batch split
        evenly over them, each part launched on its card before any is
        read back: on cards as a replay of the replica's CUDA graph for
        the part's shape and dtype (captured at the first call, by
        :meth:`warmup`)."""
        if not self.replicas:
            return self.logits(weights, images).cpu().numpy()
        parts = (torch.tensor_split(images, len(self.replicas))
                 if isinstance(images, torch.Tensor)
                 else np.array_split(images, len(self.replicas)))
        if self._replica_graphs is None:
            outs = [self.logits(w, part, device=dev)
                    for w, dev, part in zip(weights, self.replicas, parts)
                    if len(part)]
            return np.concatenate([o.cpu().numpy() for o in outs])
        with self._graph_lock:
            runs = [(self._graph(i, w, tuple(part.shape),
                                 torch.as_tensor(part[:0]).dtype), part)
                    for i, (w, part) in enumerate(zip(weights, parts))
                    if len(part)]
            for g, part in runs:
                g.launch(part)
            return np.concatenate([g.read() for g, _ in runs])

    def _graph(self, i: int, weights, shape: tuple,
               dtype: torch.dtype) -> _ReplicaGraph:
        """Replica ``i``'s graph for inputs of ``shape`` and ``dtype``,
        captured with ``weights`` (again, where the weights changed)."""
        key = (i, shape, dtype)
        g = self._replica_graphs.get(key)
        if g is None or g.weights is not weights:
            # the old graph goes first: its memory returns to the pool
            self._replica_graphs.pop(key, None)
            g = self._replica_graphs[key] = _ReplicaGraph(
                self, weights, self.replicas[i], shape, dtype,
                self._streams[i], self._pools[i])
        return g

    def _swap_weights(self, weights) -> None:
        """Serve ``weights`` (one set a replica where there are replicas)
        from the next dispatch on; the captured graphs are captured again
        with them before this returns."""
        if self._replica_graphs is None:
            self._weights = weights
            return
        with self._graph_lock:
            self._weights = weights
            for i, shape, dtype in list(self._replica_graphs):
                self._graph(i, weights[i], shape, dtype)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self, dtypes: Sequence = (np.uint8,)):
        """Run every (bucket, dtype) once, and a clip of a clip config,
        so that no request pays for cuDNN's algorithm choice or the
        kernels' build."""
        size = self.cfg.image_size
        for dt in dtypes:
            for b in self.buckets:
                self._fwd(self._weights, np.zeros((b, size, size, 3), dt))
            if self.supports_clips and self.cfg.clip_frames > 1:
                self._fwd(self._weights, np.zeros(
                    (1, self.clip_length, size, size, 3), dt))

    def predict_arrays(self, images) -> np.ndarray:
        """(N, H, W, 3) images -> (N, C) probabilities.  uint8 = raw RGB
        (normalized on device); float32 = already mean-subtracted.  A
        numpy array or a tensor (a stack of :meth:`preprocess` crops, on
        the device: padded there).  N may exceed the largest bucket; it is
        chunked."""
        out = []
        cap = self.buckets[-1]
        # snapshot once: one request sees ONE set of weights, even if a
        # concurrent reload() lands between its chunks
        weights = self._weights
        for lo in range(0, len(images), cap):
            chunk = images[lo:lo + cap]
            b = self._bucket(len(chunk))
            if len(chunk) == b:
                padded = chunk
            elif isinstance(chunk, torch.Tensor):
                padded = torch.cat([chunk, chunk.new_zeros(
                    (b - len(chunk),) + tuple(chunk.shape[1:]))])
            else:
                padded = np.concatenate([chunk, np.zeros(
                    (b - len(chunk),) + chunk.shape[1:], chunk.dtype)])
            t0 = time.monotonic()
            logits = self._fwd(weights, padded)[:len(chunk)]
            self.stats.observe_dispatch(len(chunk), len(padded),
                                        time.monotonic() - t0)
            out.append(self._probs(logits))
        return np.concatenate(out)

    def _probs(self, logits: np.ndarray) -> np.ndarray:
        if self.spec.multi_label:
            return 1.0 / (1.0 + np.exp(-logits))
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def _topk(self, probs: np.ndarray, topk: int) -> list:
        top = np.argsort(-probs)[:topk]
        return [{"class": int(c), "prob": float(probs[c])} for c in top]

    # -- the byte path --------------------------------------------------
    def preprocess(self, image_bytes: bytes) -> torch.Tensor:
        """A request's JPEG or PNG bytes -> the uint8 (S, S, 3) eval crop
        on the predictor's device (:func:`decode_image`,
        :func:`crop_decoded`)."""
        return self.preprocess_decoded(decode_image(image_bytes,
                                                    self.device))

    def preprocess_decoded(self, decoded) -> torch.Tensor:
        """The geometry half of :meth:`preprocess`, for an already decoded
        RGB uint8 (H, W, 3) image or video frame."""
        return crop_decoded(decoded, self.cfg, self.device)

    def predict_preprocessed(self, images: Sequence, topk: int = 5):
        """Already-preprocessed images (crops on the device, or arrays) ->
        per-item {"topk": [...]}: the device half of predict_bytes."""
        if isinstance(images[0], torch.Tensor):
            batch = torch.stack(list(images))
        else:
            batch = np.stack(images)
        return [{"topk": self._topk(p, topk)}
                for p in self.predict_arrays(batch)]

    def predict_bytes(self, blobs: Sequence[bytes], topk: int = 5):
        """JPEG/PNG bytes -> per-item {"topk": [...]} or {"error": ...}.
        Each blob decodes on its own, so a corrupt image gives an error in
        its own slot and the others are predicted as usual."""
        images, slots = [], []
        results: list = [None] * len(blobs)
        for i, b in enumerate(blobs):
            try:
                images.append(self.preprocess(b))
                slots.append(i)
            except Exception as exc:  # undecodable/invalid image bytes
                results[i] = {"error": f"bad image: {exc}"}
        if images:
            for i, r in zip(slots, self.predict_preprocessed(images, topk)):
                results[i] = r
        return results

    # -- video clips ----------------------------------------------------
    @property
    def clip_length(self) -> int:
        """The clip length T videos are served at: the config's
        ``clip_frames``, or 8 for an image config."""
        return self.cfg.clip_frames if self.cfg.clip_frames > 1 else 8

    def predict_clip_bytes(self, frame_blobs: Sequence[bytes],
                           topk: int = 5):
        """One video as its ordered encoded frames -> one clip-pooled
        prediction: the frames are TSN-subsampled (or repeated) to
        :attr:`clip_length`, each cropped as :meth:`preprocess` does, and
        run as one (1, T, S, S, 3) clip.  {"topk": [...], "clip_frames",
        "frames_received"} or {"error": ...}."""
        if not self.supports_clips:
            return {"error": NO_CLIP_FORWARD}
        if not frame_blobs:
            return {"error": "bad video: no frames"}
        picks = _segment_picks(len(frame_blobs), self.clip_length)
        try:
            frames = [self.preprocess(frame_blobs[p]) for p in picks]
        except Exception as exc:
            return {"error": f"bad video frame: {exc}"}
        return self._predict_clip(frames, topk,
                                  frames_received=len(frame_blobs))

    def predict_video_bytes(self, video_bytes: bytes, topk: int = 5):
        """One encoded video file -> one clip-pooled prediction: the TSN
        picks decoded from the container (:func:`decode_video_frames`,
        OpenCV) and cropped as :meth:`predict_clip_bytes` crops frames.
        Where OpenCV is missing the answer is {"error": "bad video:
        ..."}."""
        if not self.supports_clips:
            return {"error": NO_CLIP_FORWARD}
        try:
            frames, n = decode_video_frames(video_bytes, self.clip_length)
            frames = [self.preprocess_decoded(fr) for fr in frames]
        except Exception as exc:
            return {"error": f"bad video: {exc}"}
        return self._predict_clip(frames, topk, frames_received=n)

    def _predict_clip(self, frames, topk: int, frames_received: int):
        """The clip entry points' tail: ``frames`` are the clip_length
        uint8 crops, in temporal order."""
        clip = torch.stack(frames)[None]          # (1, T, S, S, 3) uint8
        t0 = time.monotonic()
        logits = self._fwd(self._weights, clip)
        self.stats.observe_dispatch(1, 1, time.monotonic() - t0)
        return {"topk": self._topk(self._probs(logits)[0], topk),
                "clip_frames": int(self.clip_length),
                "frames_received": int(frames_received)}


class Predictor(BucketedPredictor):
    """Flax-layout weights -> padded, bucketed batch inference on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).

    Input contract: uint8 images (raw 0-255 RGB, mean-subtracted on the
    device) or float32 images already mean-subtracted.  With ``int8`` the
    forward is the BN-folded int8 one in bfloat16 activations, with static
    activation scales calibrated on ``calibration_images`` (mean-subtracted
    float (N, S, S, 3), an array or a tensor) or, without them, per
    example.  Both serve (1, T, S, S, 3) clips too.  ``data_parallel``
    serves one replica a local card (``devices``, default every card of
    ``device``'s type), when there is more than one."""

    supports_clips = True

    def __init__(self, cfg: config_lib.TrainConfig, params, batch_stats, *,
                 int8: bool = False, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 calibration_images=None, stats: ServingStats | None = None,
                 data_parallel: bool = False, devices=None, device=None):
        self.cfg = cfg
        self.spec = get_dataset(cfg.dataset)
        self.int8 = int8
        self.device = resolve_device(device)
        self.stats = stats or ServingStats()
        self.buckets = self._init_data_parallel(data_parallel, buckets,
                                                devices)
        self._pooling = "avg" if cfg.pooling == "avg" else "attention"
        self._calib = (None if calibration_images is None else
                       torch.as_tensor(calibration_images,
                                       dtype=torch.float32,
                                       device=self.device))
        self._weights = self._make_all(params, batch_stats)

    def _make_all(self, params, batch_stats):
        """:meth:`_make_weights` on the predictor's device, or one set a
        replica."""
        if not self.replicas:
            return self._make_weights(params, batch_stats, self.device)
        return tuple(self._make_weights(params, batch_stats, d)
                     for d in self.replicas)

    def _make_weights(self, params, batch_stats, device):
        """Servable weights on ``device``, which never change once made
        (reload() makes new ones and swaps them in): a model holding the
        given weights, or on the int8 path ``(quantized backbone, head,
        activation scales or None)``, calibrated again on the retained
        calibration images."""
        if not self.int8:
            model = build_model(self.cfg, device=device)
            return load_flax_variables(model, params, batch_stats)
        folded = inf.fold_backbone(
            {"params": params, "batch_stats": batch_stats},
            self.cfg.backbone, device=device)
        head = inf.head_weights(params, device)["head"]
        act_scales = None
        if self._calib is not None:
            act_scales = inf.scale_tensors(inf.calibrate_act_scales(
                folded, head, [self._calib.to(device)],
                backbone=self.cfg.backbone, pooling=self._pooling), device)
        return inf.quantize_folded(folded), head, act_scales

    def forward(self, weights, images: torch.Tensor) -> torch.Tensor:
        """float32 logits of uint8 or float32 (B, S, S, 3) images or (B,
        T, S, S, 3) clips, tensors on the weights' device, normalization
        included: the function that ``export.py`` traces, so it takes no
        gradient mode of its own.  ``weights`` is :attr:`_weights` or
        what ``export.py`` rebuilds from its traced inputs."""
        x = normalize_images(images)
        if self.int8:
            q, head, act_scales = weights
            return inf.folded_forward(
                q, head, x, backbone=self.cfg.backbone,
                pooling=self._pooling, act_scales=act_scales,
                dtype=torch.bfloat16)["logits"]
        return weights(x)["logits"].to(torch.float32)

    @torch.inference_mode()
    def logits(self, weights, images, device=None) -> torch.Tensor:
        """float32 logits on ``device`` (default the predictor's; the
        weights' own) of (B, S, S, 3) images or (B, T, S, S, 3) clips
        (numpy or tensors)."""
        return self.forward(weights,
                            as_device_tensor(images, device or self.device))

    def reload(self, params, batch_stats, *, step=None):
        """Hot-swap the served weights: in-flight dispatches hold the old
        ones and finish on them; requests after the (atomic) swap see the
        new ones.  The int8 path folds, calibrates (on the same retained
        images) and quantizes the new weights."""
        self._swap_weights(self._make_all(params, batch_stats))
        self.stats.inc("serving_reloads_total")
        if step is not None:
            self.step = int(step)
            self.stats.set_gauge("serving_checkpoint_step", int(step))


class DynamicBatcher:
    """Coalesce concurrent single requests into one device dispatch.

    submit() returns a Future; a worker thread drains the queue, waiting at
    most ``max_wait_ms`` after the first request to fill up to
    ``max_batch``, then runs ``predict_fn`` on the coalesced batch.

    Admission control: the queue is bounded by ``max_queue`` items; when
    full, submit() raises :class:`Overloaded` immediately (counted as
    ``serving_rejected_total``).  The live depth is exported as the
    ``serving_queue_depth`` gauge.
    """

    def __init__(self, predict_fn, *, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 max_queue: int | None = 1024,
                 stats: ServingStats | None = None):
        self._predict = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.max_queue = max_queue
        self.stats = stats or ServingStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # serializes submit's check+put against stop's drain: without it a
        # submitter could pass the stop check, get descheduled across the
        # whole stop() (flag, join, drain), then enqueue into the abandoned
        # queue and leave a future that never resolves
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, item) -> Future:
        """Fast-fail admission for one item (through :meth:`submit_many`,
        so the check+put critical section exists once)."""
        return self.submit_many([item])[0]

    def submit_many(self, items) -> list[Future]:
        """Atomically admit a whole multi-item request: either EVERY item
        enqueues or none does (:class:`Overloaded`), so a rejected batch
        costs no device work."""
        items = list(items)
        futs: list[Future] = []
        with self._submit_lock:
            if self._stop.is_set():
                for _ in items:
                    fut: Future = Future()
                    fut.set_exception(RuntimeError("batcher is shut down"))
                    futs.append(fut)
                return futs
            if self.max_queue is not None and (
                    self._q.qsize() + len(items) > self.max_queue):
                # one rejected request = len(items) rejected predictions
                self.stats.inc("serving_rejected_total", len(items))
                if len(items) == 1:   # the single-submit wording
                    raise Overloaded(
                        f"request queue full ({self.max_queue} pending)")
                raise Overloaded(
                    f"request queue cannot admit {len(items)} items "
                    f"({self._q.qsize()}/{self.max_queue} pending)"
                    + ("; batch exceeds total queue capacity — split it"
                       if len(items) > self.max_queue else ""))
            for item in items:
                fut = Future()
                self._q.put((item, fut))
                futs.append(fut)
            self.stats.set_gauge("serving_queue_depth", self._q.qsize())
        return futs

    def retry_after_seconds(self) -> int:
        """``Retry-After`` for 429s: batches to drain the current queue x
        (measured mean dispatch time + the coalescing wait), at least 1."""
        snap = self.stats.snapshot()
        n = snap.get("serving_device_dispatches_total", 0.0)
        per_dispatch = (snap.get("serving_device_seconds_sum", 0.0) / n
                        if n else 0.05)   # pre-traffic guess; self-corrects
        batches = math.ceil(max(self._q.qsize(), 1) / self.max_batch)
        return max(1, math.ceil(batches * (per_dispatch + self.max_wait)))

    def stop(self):
        """Shut down: join the worker, then fail every still-queued future
        so blocked callers error at once instead of waiting out their
        result() timeout."""
        self._stop.set()
        self._thread.join(timeout=5)
        with self._submit_lock:   # no submit can interleave with the drain
            while True:
                try:
                    _, fut = self._q.get_nowait()
                except queue.Empty:
                    break
                if not fut.done():
                    fut.set_exception(RuntimeError("batcher shut down"))

    def _worker(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            t0 = time.monotonic()
            while (len(batch) < self.max_batch
                   and (time.monotonic() - t0) < self.max_wait):
                try:
                    batch.append(self._q.get(timeout=max(
                        0.0, self.max_wait - (time.monotonic() - t0))))
                except queue.Empty:
                    break
            items = [b[0] for b in batch]
            futures = [b[1] for b in batch]
            self.stats.set_gauge("serving_queue_depth", self._q.qsize())
            self.stats.inc("serving_coalesced_batches_total")
            self.stats.inc("serving_coalesced_items_total", len(items))
            try:
                results = self._predict(items)
                # a short/long result list would otherwise leave futures
                # unresolved forever — fail the whole batch loudly instead
                if len(results) != len(items):
                    raise RuntimeError(
                        f"predict_fn returned {len(results)} results for "
                        f"{len(items)} items")
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as exc:
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(exc)


def deploy_params(restored, use_ema: bool):
    """The (params, batch_stats) a deployment serves from a restored
    step: the EMA shadow when requested, else the raw params.  Shared by
    load_predictor and CheckpointFollower, so that a follow reload applies
    the same choice as the initial load."""
    if use_ema:
        if restored.ema_params is None:
            raise ValueError(
                "use_ema=True but the checkpoint has no ema_params — "
                "train with --set ema_decay=0.9999 (or similar) first")
        return restored.ema_params, restored.batch_stats
    return restored.params, restored.batch_stats


class CheckpointFollower(threading.Thread):
    """Continuous deployment: poll a ``checkpoint.CheckpointManager`` for
    new steps and hot-swap them into a live Predictor
    (:meth:`Predictor.reload`).  Point it at the rolling ``checkpoints/``
    manager to track training, or at the ``checkpoints_best`` slot
    (``manager_for_step(workdir, "best")``) to serve the best checkpoint.

    A failed poll (a step pruned mid-read, transient IO) is logged and
    retried next period; the predictor keeps serving the old weights."""

    def __init__(self, predictor: "Predictor", manager, *,
                 use_ema: bool = False, poll_seconds: float = 10.0):
        super().__init__(daemon=True, name="ckpt-follower")
        self._predictor = predictor
        self._mgr = manager
        self._use_ema = use_ema
        self._poll = poll_seconds
        self._stopev = threading.Event()

    def poll_once(self) -> bool:
        """One poll: reload and swap if a step newer than the served one
        is committed.  Returns whether a swap happened."""
        self._mgr.reload()
        latest = self._mgr.latest_step()
        served = getattr(self._predictor, "step", None)
        if latest is None or (served is not None and latest <= served):
            return False
        restored = ckpt_lib.restore_for_eval(self._mgr, step=latest)
        if restored is None:
            return False
        params, batch_stats = deploy_params(restored, self._use_ema)
        self._predictor.reload(params, batch_stats, step=latest)
        log.info("hot-reloaded checkpoint step %d", latest)
        return True

    def run(self):
        while not self._stopev.wait(self._poll):
            try:
                self.poll_once()
            except Exception:
                log.exception("checkpoint follow poll failed; serving "
                              "continues on the current weights")

    def stop(self):
        self._stopev.set()
        if self.is_alive():
            self.join(timeout=5)


def load_predictor(cfg: config_lib.TrainConfig, *, step=None,
                   int8: bool = False,
                   buckets: Sequence[int] = DEFAULT_BUCKETS,
                   calibration_files: Sequence[str] = (),
                   data_parallel: bool = False,
                   use_ema: bool = False, devices=None,
                   device=None) -> Predictor:
    """Restore the latest (or ``step``) checkpoint under ``cfg.workdir``
    and build a Predictor on ``device`` (default ``cuda``).  ``step`` may
    also be the string ``"best"``: the keep-best slot
    (``checkpoint.BestKeeper``).  ``use_ema`` serves the EMA weights.

    ``int8`` serves the quantized BN-folded path; with
    ``calibration_files`` (paths of representative JPEG or PNG images,
    decoded and cropped on the device to mean-subtracted float32) its
    activation scales are static, else per example.  ``data_parallel``
    serves a replica on each of ``devices`` (default every local card),
    where there is more than one."""
    device = resolve_device(device)
    mgr, step = ckpt_lib.manager_for_step(cfg.workdir, step)
    restored = ckpt_lib.restore_for_eval(mgr, step=step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
    params, batch_stats = deploy_params(restored, use_ema)
    calib = None
    if int8 and calibration_files:
        crops = []
        for path in calibration_files:
            with open(path, "rb") as f:
                crops.append(crop_decoded(decode_image(f.read(), device),
                                          cfg, device, keep_uint8=False))
        calib = torch.stack(crops)
    predictor = Predictor(cfg, params, batch_stats, int8=int8,
                          buckets=buckets, calibration_images=calib,
                          data_parallel=data_parallel, devices=devices,
                          device=device)
    # served-step bookkeeping: CheckpointFollower compares against this
    # to decide when a newer committed step warrants a hot reload
    predictor.step = int(restored.step)
    predictor.stats.set_gauge("serving_checkpoint_step", int(restored.step))
    return predictor
