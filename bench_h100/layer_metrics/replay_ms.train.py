"""Host-clock milliseconds a step spent around its CUDA graph's launch:
handing the graph its batch, learning rate and EMA decay, and copying its
metrics out.  The port's ``train.replay`` spans' self time (less their
child ``train.graph_launch``, the ``graph.replay()`` call, whose time
under the profiler is mostly CUPTI's cost a node) over its ``train.step``
spans, over the traced steps (``utils/profiling.py``).  Nothing where
the port keeps no such span."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    tot = span_totals()
    t, steps = tot.get("train.replay"), tot.get("train.step")
    return 1e3 * t["self_seconds"] / steps["count"] if t and steps else None
