"""Online serving: bucketed-batch predictor + dynamic request batching.
Port of the JAX package's ``serving.py`` (the float, single-device path).

  * **Shape bucketing.** Requests are padded up to the next batch bucket
    (default 1/8/32/128); ``warmup()`` runs every bucket once so that cuDNN
    picks its algorithms and the kernels are built before the first
    request.
  * **Dynamic batching.** ``DynamicBatcher`` coalesces concurrent requests
    into one device dispatch (bounded wait).

The ``Predictor`` is built from Flax-layout (params, batch_stats) arrays
through the weight bridge (``convert.py``); ``load_predictor`` builds one
from a checkpoint of the port (the latest step, a step, or the keep-best
slot), and ``CheckpointFollower`` hot-swaps newer steps into it.  Not
ported yet: JPEG and video decode, int8, data-parallel serving, export.
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
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.device import resolve_device
from attentionalpoolingaction_torch.train import build_model, normalize_images

DEFAULT_BUCKETS = (1, 8, 32, 128)

log = logging.getLogger(__name__)


class Overloaded(RuntimeError):
    """The DynamicBatcher's bounded queue is full: the server is taking
    requests faster than the device drains them.  Raised synchronously by
    submit() so the HTTP layer can answer 429 + Retry-After at once."""


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


class BucketedPredictor:
    """Shape-bucketed padded batch inference over a forward fn.

    Subclass ``__init__`` must set ``cfg``, ``spec``, ``stats``,
    ``buckets``, ``_weights`` and ``_fwd(weights, images) -> logits``
    (a numpy (B, C) float32 array)."""

    cfg: config_lib.TrainConfig
    buckets: tuple

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self, dtypes: Sequence = (np.uint8,)):
        """Run every (bucket, dtype) once so that no request pays for
        cuDNN's algorithm choice or the kernels' build."""
        size = self.cfg.image_size
        for dt in dtypes:
            for b in self.buckets:
                self._fwd(self._weights, np.zeros((b, size, size, 3), dt))

    def predict_arrays(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) images -> (N, C) probabilities.  uint8 = raw RGB
        (normalized on device); float32 = already mean-subtracted.  N may
        exceed the largest bucket; it is chunked."""
        out = []
        cap = self.buckets[-1]
        # snapshot once: one request sees ONE set of weights, even if a
        # concurrent reload() lands between its chunks
        weights = self._weights
        for lo in range(0, len(images), cap):
            chunk = images[lo:lo + cap]
            b = self._bucket(len(chunk))
            if len(chunk) < b:
                pad = np.zeros((b - len(chunk),) + chunk.shape[1:],
                               chunk.dtype)
                padded = np.concatenate([chunk, pad])
            else:
                padded = chunk
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

    def predict_preprocessed(self, images: Sequence[np.ndarray],
                             topk: int = 5):
        """Already-preprocessed images -> per-item {"topk": [...]}: the
        device half of the JAX package's predict_bytes."""
        probs = self.predict_arrays(np.stack(images))
        out = []
        for p in probs:
            top = np.argsort(-p)[:topk]
            out.append({"topk": [{"class": int(c), "prob": float(p[c])}
                                 for c in top]})
        return out


class Predictor(BucketedPredictor):
    """Flax-layout weights -> padded, bucketed batch inference on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).

    Input contract: uint8 images (raw 0-255 RGB, mean-subtracted on the
    device) or float32 images already mean-subtracted."""

    def __init__(self, cfg: config_lib.TrainConfig, params, batch_stats, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 stats: ServingStats | None = None, device=None):
        self.cfg = cfg
        self.spec = get_dataset(cfg.dataset)
        self.device = resolve_device(device)
        self.stats = stats or ServingStats()
        self.buckets = tuple(sorted(set(buckets)))
        self._weights = self._make_weights(params, batch_stats)

    def _make_weights(self, params, batch_stats):
        """A servable model holding the given weights.  The weights of one
        model never change: reload() builds a new one and swaps it in."""
        model = build_model(self.cfg, device=self.device)
        return load_flax_variables(model, params, batch_stats)

    @torch.inference_mode()
    def _fwd(self, model, images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        logits = model(normalize_images(x))["logits"]
        return logits.to(torch.float32).cpu().numpy()

    def reload(self, params, batch_stats, *, step=None):
        """Hot-swap the served weights: in-flight dispatches hold the old
        model and finish on it; requests after the (atomic) swap see the
        new one."""
        self._weights = self._make_weights(params, batch_stats)
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
                   use_ema: bool = False, device=None) -> Predictor:
    """Restore the latest (or ``step``) checkpoint under ``cfg.workdir``
    and build a Predictor on ``device`` (default ``cuda``).  ``step`` may
    also be the string ``"best"``: the keep-best slot
    (``checkpoint.BestKeeper``).  ``use_ema`` serves the EMA weights.
    ``int8``, ``calibration_files`` and ``data_parallel`` are not ported
    yet and raise."""
    if int8 or calibration_files:
        raise NotImplementedError("int8 serving is not ported yet")
    if data_parallel:
        raise NotImplementedError("data-parallel serving is not ported yet")
    mgr, step = ckpt_lib.manager_for_step(cfg.workdir, step)
    restored = ckpt_lib.restore_for_eval(mgr, step=step)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {mgr.directory}")
    params, batch_stats = deploy_params(restored, use_ema)
    predictor = Predictor(cfg, params, batch_stats, buckets=buckets,
                          device=device)
    # served-step bookkeeping: CheckpointFollower compares against this
    # to decide when a newer committed step warrants a hot reload
    predictor.step = int(restored.step)
    predictor.stats.set_gauge("serving_checkpoint_step", int(restored.step))
    return predictor
