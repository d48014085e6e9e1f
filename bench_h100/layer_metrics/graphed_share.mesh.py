"""Share of rank 0's traced steps that ran as a replay of a CUDA graph:
the port's ``train.replay`` spans over its ``train.step`` spans, in
percent, from the span totals the worker handed over (``span_totals``,
as ``allreduce_ms.mesh`` reads them).  Nothing where no trace was taken
or the port keeps no such span (an eager mesh step)."""


def read(ctx):
    tot = ctx.get("span_totals")
    if ctx.get("trace") is None or not tot:
        return None
    t, steps = tot.get("train.replay"), tot.get("train.step")
    return 100.0 * t["count"] / steps["count"] if t and steps else None
