"""Tracing and timing: the port of the JAX package's ``utils/profiling.py``
with ``torch.profiler`` in place of ``jax.profiler``.  A trace is a
Chrome trace (``chrome://tracing``, Perfetto) of the host's ops and, on a
card, its kernels and copies, written as ``<logdir>/trace_<time>.json``
when the window closes.

Spans: ``with span("train.input"):`` marks where the port's host time
goes, at its layer boundaries, while any torch profiler runs (this
module's ``trace()``, a hook of ``make_trace_hook``, or another caller's
``torch.profiler.profile``).  With no profiler running a span costs a read
of ``torch.autograd.profiler._is_profiler_enabled`` (a process-wide flag)
and a store, and records nothing.  While one runs, each span appends a
:class:`Span` to a bounded buffer in memory: its name, thread, start and
end in ``time.time_ns()`` (the clock of the Chrome trace's
``baseTimeNanoseconds + ts``), its parent and its ids.  Spans are kept
from every thread, where the profiler records host events only on the
thread that started it; on such a thread a span also enters
``record_function``, so it shows in the trace as a ``user_annotation``.
``record_span`` records a wait that crosses threads from explicit times.
The buffer holds the latest profiling session: it is cleared at the
first span of a session, seen as a span while profiling after a span
while not (or after ``trace()``'s start).  ``spans()`` gives the records,
``span_totals()`` their counts, seconds and self seconds by name.

``start_server`` (a live profiler endpoint) has no torch counterpart and
raises.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["MAX_SPANS", "Span", "current", "dropped_spans", "make_trace_hook",
           "profiler_running", "record_span", "span", "span_totals", "spans",
           "start_server", "timed", "trace"]

# records a session keeps; later ones are counted in ``dropped_spans()``
MAX_SPANS = 100_000


def profiler_running() -> bool:
    """Whether a torch profiler runs anywhere in the process (False where
    this torch has no such flag: spans then record nothing)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class Span:
    """One span: ``name``, ``thread`` (``threading.get_ident()``),
    ``start_ns`` and ``end_ns`` (``time.time_ns()``), ``parent`` (a Span or
    None) and ``ids`` (its own: a request id, a step, an image count).
    :meth:`get` reads an id from the span or its nearest ancestor.  Made
    by :func:`span` (a context manager) and :func:`record_span`."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "parent", "ids",
                 "_session", "_rf")

    def __init__(self, name: str, parent: Span | None, ids: dict):
        self.name, self.parent, self.ids = name, parent, ids
        self.thread = threading.get_ident()
        self._session = _buffer.session
        self.start_ns = self.end_ns = 0
        self._rf = None

    def get(self, key: str, default=None):
        s = self
        while s is not None:
            if key in s.ids:
                return s.ids[key]
            s = s.parent
        return default

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> Span:
        stack = _stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self)
        if torch._C._autograd._profiler_enabled():     # this thread's
            self._rf = record_function(self.name)
            self._rf.__enter__()
        # read after the mark is entered, whose start the profiler takes
        # inside that call: entering costs tens of microseconds, and more
        # at a session's first mark, which would otherwise fall between
        # the span's start and its mark's
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _stack().remove(self)
        _buffer.add(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, "
                f"ids={self.ids})")


# the span of a process where no profiler runs
_NO_SPAN = contextlib.nullcontext()


class _Buffer:
    """The latest session's spans, shared by every thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records: list[Span] = []
        self.dropped = 0
        self.session = 0
        # a span ran with no profiler since the last one that did: the
        # next span under a profiler starts a new session
        self.stale = True

    def begin(self) -> None:
        if self.stale:
            with self.lock:
                if self.stale:
                    self.records, self.dropped = [], 0
                    self.session += 1
                    self.stale = False

    def add(self, s: Span) -> None:
        with self.lock:
            if s._session != self.session:
                return
            if len(self.records) < MAX_SPANS:
                self.records.append(s)
            else:
                self.dropped += 1


_buffer = _Buffer()
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, parent: Span | None = None, **ids):
    """``with span(name, **ids) as s:``: a span of the block while a
    profiler runs (``s`` is the :class:`Span`, to hand to another thread as
    a ``parent``), nothing otherwise (``s`` is None).  Its parent is
    ``parent`` or the innermost span open on this thread."""
    if not profiler_running():
        _buffer.stale = True
        return _NO_SPAN
    _buffer.begin()
    return Span(name, parent, ids)


def record_span(name: str, start_ns: int, end_ns: int,
                parent: Span | None = None, **ids) -> None:
    """Record a span from explicit ``time.time_ns()`` times, such as a wait
    that began on another thread; its parent is ``parent`` or the
    innermost span open on this thread."""
    if not profiler_running():
        _buffer.stale = True
        return
    _buffer.begin()
    s = Span(name, parent if parent is not None else current(), ids)
    s.start_ns, s.end_ns = start_ns, end_ns
    _buffer.add(s)


def current() -> Span | None:
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def spans() -> list[Span]:
    """The latest session's spans, in the order they ended."""
    with _buffer.lock:
        return list(_buffer.records)


def dropped_spans() -> int:
    """Spans of the latest session past ``MAX_SPANS``, not kept."""
    return _buffer.dropped


def _covered(intervals: list) -> int:
    """Nanoseconds covered by the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def span_totals() -> dict[str, dict]:
    """For each span name of the latest session: ``count``, ``seconds``
    (the sum of durations), ``self_seconds`` (each duration minus the part
    of it its children cover) and, for each numeric id the spans were
    given, its sum (an image count adds up; the sum of a step or a request
    id means nothing)."""
    records = spans()
    children = collections.defaultdict(list)
    for s in records:
        if s.parent is not None:
            children[id(s.parent)].append(s)
    out: dict[str, dict] = {}
    for s in records:
        t = out.setdefault(s.name, {"count": 0, "seconds": 0.0,
                                    "self_seconds": 0.0})
        t["count"] += 1
        t["seconds"] += s.seconds
        inside = [(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                  for c in children.get(id(s), ())]
        covered = _covered([(a, b) for a, b in inside if b > a])
        t["self_seconds"] += (s.end_ns - s.start_ns - covered) * 1e-9
        for k, v in s.ids.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                t[k] = t.get(k, 0) + v
    return out


def _start() -> profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    _buffer.stale = True        # a new session, whatever ran before
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
