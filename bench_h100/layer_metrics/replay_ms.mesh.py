"""Host-clock milliseconds a step of rank 0 spent around its CUDA
graph's launch (the batch into the static inputs, the learning rate, the
metrics' copies): the self time of the port's ``train.replay`` spans,
less their child ``train.graph_launch``, over its ``train.step`` spans,
from the span totals the worker handed over (``span_totals``).  Nothing
where no trace was taken or the port keeps no such span (an eager mesh
step)."""


def read(ctx):
    tot = ctx.get("span_totals")
    if ctx.get("trace") is None or not tot:
        return None
    t, steps = tot.get("train.replay"), tot.get("train.step")
    return 1e3 * t["self_seconds"] / steps["count"] if t and steps else None
