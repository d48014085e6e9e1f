"""Host-clock milliseconds a step spent getting its batch (the pipeline's
hand-off, its decode and the copy to the card): the port's
``train.input`` spans over its ``train.step`` spans, over the traced
steps (``utils/profiling.py``)."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    tot = span_totals()
    t, steps = tot.get("train.input"), tot.get("train.step")
    return 1e3 * t["seconds"] / steps["count"] if t and steps else None
