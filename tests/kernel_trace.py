"""Which of the port's kernels a block ran, and how often, read from the
profiler's trace of it, beside the port's spans of the same block.

    result, trace = kernel_trace.traced(lambda: model(x))
    trace.launches      # {"saliency_summary": 1, "project_logits": 1, ...}
    trace.spans("jpeg.decode")

:func:`traced` runs the block under ``torch.profiler.profile`` with the
CUDA activity where there is a card (the CPU one where there is none),
synchronizes every card, and counts the device's kernel events by the
name of their ``__global__`` function.  A CUDA graph's replay runs the
kernels its capture recorded, and the trace names each of them, so a
replay counts them all; the capture itself runs none.  While the profiler
runs, the port's spans (``utils/profiling.py``) record in the same block,
from every thread.  On the CPU the trace holds no kernel and every count
is 0.

On a card the window holds the block between two idle stretches of
:data:`PAD_S`.  The trace keeps only kernels whose times fall inside its
window, and once a process has traced for a while an H100 trace (torch
2.11, CUDA 12.8) placed the kernels of a short window outside it: with
no stretch, or 1.5 s before the block, every later window came back
empty; with 3 s on one side two windows held their kernels and the next
ones none; with 2 s on both sides every window held all of them.  The
CPU activity stays off on a card: the port's spans do not need it.

The card tests and ``chip_smoke.py`` count with it.  No JAX here.
"""

from __future__ import annotations

import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from attentionalpoolingaction_torch.utils import profiling

# the port's hand-written kernels: short name -> the __global__ function
KERNELS = {"saliency_summary": "saliency_summary_kernel",
           "project_logits": "project_logits_kernel",
           "pool_backward": "pool_backward_kernel",
           "ycc_to_rgb": "YccToRgbBatchKernel"}
# the function's name as a whole identifier of the demangled signature
_PATTERNS = {short: re.compile(rf"(?<![\w]){name}(?![\w])")
             for short, name in KERNELS.items()}
# seconds of idle window before and after the block on a card
PAD_S = 2.0


class Trace:
    """``launches``: each of :data:`KERNELS` by short name, the times the
    device ran it; ``seconds``: the block's host time to its last
    synchronize; :meth:`spans`: the port's spans of the block."""

    def __init__(self, launches: dict, seconds: float, spans: list):
        self.launches, self.seconds, self._spans = launches, seconds, spans

    def spans(self, name: str) -> list:
        return [s for s in self._spans if s.name == name]


def count_kernels(names) -> dict:
    """The launches of each of :data:`KERNELS` among kernel ``names``."""
    launches = dict.fromkeys(KERNELS, 0)
    for name in names:
        for short, pattern in _PATTERNS.items():
            if pattern.search(name):
                launches[short] += 1
    return launches


def traced(fn):
    """``fn()``'s result and the :class:`Trace` of the call."""
    # a span while no profiler runs: the block's first span then starts a
    # new session of the span buffer.  A block that makes no span leaves
    # the last session's in it, so spans are taken from the block's start.
    with profiling.span("kernel_trace.before"):
        pass
    start_ns = time.time_ns()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    activity = ProfilerActivity.CUDA if cards else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        time.sleep(PAD_S if cards else 0)
        t0 = time.perf_counter()
        result = fn()
        for i in range(cards):
            torch.cuda.synchronize(i)
        seconds = time.perf_counter() - t0
        time.sleep(PAD_S if cards else 0)
    # the raw events: kernels need no parse into the tree of host events
    events = prof.profiler.kineto_results.events()
    launches = count_kernels(e.name() for e in events
                             if e.device_type() == DeviceType.CUDA)
    return result, Trace(launches, seconds, [s for s in profiling.spans()
                                             if s.start_ns >= start_ns])
