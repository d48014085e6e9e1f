"""Host-clock milliseconds an image waited in the batcher's queue, from
its ``put`` to the hand-off of its batch to the forward: the mean of the
port's ``serve.queue_wait`` spans (``utils/profiling.py``) over the
traced part of the window."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    t = span_totals().get("serve.queue_wait")
    return 1e3 * t["seconds"] / t["count"] if t else None
