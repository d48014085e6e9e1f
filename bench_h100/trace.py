"""The traced run's reading of the device: ``torch.profiler`` over a part
of the window, its Chrome trace read back into busy time, idle gaps, the
device operations by time and each kernel's launches and time.

Busy time is the union of the device's kernel, copy and set intervals;
the traced window is the host clock between the profiler's start and
stop.  An idle gap (between two busy intervals) is put down to what the
host was doing at its middle: the innermost host event open then, a span
of the benchmark's own (``record_function``) or an operator.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict           # name -> [launches, seconds]
    idle_by_host: dict      # host activity -> seconds idle

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v[1]] for n, v in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps]}

    def kernel_time(self, substring: str) -> tuple[int, float]:
        n = s = 0
        for name, (c, t) in self.kernels.items():
            if substring in name:
                n += c
                s += t
        return n, s


class Tracer:
    """``start()`` and ``stop()`` around the traced part of a window, on
    the host thread that opens it; ``summary`` once the window has closed
    (the trace is written out and read then, not inside the window)."""

    def __init__(self, tmpdir: str):
        self.path = os.path.join(tmpdir, "trace.json")
        self._summary: Summary | None = None
        self._prof = self._done = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.monotonic()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window = time.monotonic() - self._t0
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    @property
    def summary(self) -> Summary | None:
        if self._summary is None and self._done is not None:
            self._done.export_chrome_trace(self.path)
            self._done = None
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(self.path)
            self._summary = summarize(events, self._window)
        return self._summary


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, window_s: float) -> Summary:
    dev, host = [], []
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            k = kernels[e.get("name", "?")]
            k[0] += 1
            k[1] += dur * 1e-6
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?"), cat))
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.defaultdict(float)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    for length, s, e in gaps[:2000]:
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(starts, mid) - 1
        label = "no operator open (Python or a wait)"
        for k in range(j, max(j - 3000, -1), -1):
            hs, he, name, cat = host[k]
            if he >= mid:
                label = name if cat == "user_annotation" else f"op {name}"
                break
        idle[label] += length * 1e-6
    rest = sum(g[0] for g in gaps[2000:]) * 1e-6
    if rest:
        idle["short gaps"] += rest
    return Summary(window_s=window_s, busy_s=min(busy, window_s),
                   kernels={k: v for k, v in kernels.items()},
                   idle_by_host=dict(idle))
