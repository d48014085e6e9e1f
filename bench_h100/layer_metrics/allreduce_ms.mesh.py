"""Host-clock milliseconds a step spent in the gradients' exchange on
rank 0: the port's ``train.all_reduce`` spans (around
``parallel/mesh.all_reduce_flat`` of the gradients) over its
``train.step`` spans, over the traced steps (``utils/profiling.py``, read
by the worker and handed over as ``span_totals``).  Nothing where the port
keeps no such span."""


def read(ctx):
    tot = ctx.get("span_totals")
    if ctx.get("trace") is None or not tot:
        return None
    t, steps = tot.get("train.all_reduce"), tot.get("train.step")
    return 1e3 * t["seconds"] / steps["count"] if t and steps else None
