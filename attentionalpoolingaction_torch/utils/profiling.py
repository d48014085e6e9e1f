"""Tracing and timing: the port of the JAX package's ``utils/profiling.py``
with ``torch.profiler`` in place of ``jax.profiler``.  A trace is a
Chrome trace (``chrome://tracing``, Perfetto) of the host's ops and, on a
card, its kernels and copies, written as ``<logdir>/trace_<time>.json``
when the window closes.

``start_server`` (a live profiler endpoint) has no torch counterpart and
raises.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["StepTimer", "make_trace_hook", "start_server", "timed", "trace"]


def _start() -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop(prof: profile, logdir: str) -> str:
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block: ``with profiling.trace(d): step()``."""
    prof = _start()
    try:
        yield prof
    finally:
        _stop(prof, logdir)


def make_trace_hook(logdir: str, start_step: int, num_steps: int = 3,
                    last_step: int | None = None):
    """Train-loop hook (``train_cli --trace_at_step``): trace ``num_steps``
    steps once the loop reaches ``start_step``; the window brackets real
    steps of the run, input pipeline and copies included.

    ``last_step``: the run's final step; the trace is written there even
    if fewer than ``num_steps`` were captured, and an atexit fallback
    writes a trace left open by any other early exit of the loop."""
    import atexit

    state = {"prof": None, "done": False}

    def _finish():
        if state["prof"] is not None:
            _stop(state["prof"], logdir)
            state["prof"] = None
            state["done"] = True

    atexit.register(_finish)

    def hook(step, train_state, metrics):
        del train_state, metrics
        if state["done"]:
            return
        if state["prof"] is None and step >= start_step:
            state["prof"] = _start()
            state["stop_at"] = step + num_steps
        if state["prof"] is not None and (
                step >= state["stop_at"]
                or (last_step is not None and step >= last_step)):
            _finish()

    return hook


def start_server(port: int = 9999):
    raise NotImplementedError(
        "a live profiler server has no torch counterpart; use trace() or "
        "train_cli --trace_at_step")


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 2, iters: int = 10, **kw) -> float:
    """Seconds a call of ``fn``, by the host's clock around ``iters``
    calls after ``warmup``, the device synchronized at both ends."""
    for _ in range(warmup):
        fn(*args, **kw)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kw)
    _synchronize()
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Rolling images/sec meter for the train loop."""

    def __init__(self, batch_size: int, window: int = 50):
        self.batch_size = batch_size
        self.window = window
        self._t = None
        self._times = []

    def tick(self):
        now = time.perf_counter()
        if self._t is not None:
            self._times.append(now - self._t)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._t = now

    @property
    def images_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return self.batch_size / (sum(self._times) / len(self._times))
