"""Share of the traced steps that ran as a replay of a CUDA graph: the
port's ``train.replay`` spans over its ``train.step`` spans, in percent
(``utils/profiling.py``).  Nothing where the port keeps no such span."""


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
    return 100.0 * t["count"] / steps["count"] if t and steps else None
