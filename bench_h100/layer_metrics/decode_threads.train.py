"""Threads a call of the byte path decoded its images on: the port's
``jpeg.decode`` spans' ``threads`` ids (1 for a call decoded inline on
the consumer's thread, more for one spread over the decode pool,
``data/jpeg.py``) over the traced steps, their mean a call.  Nothing where
the port's spans carry no such id."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    t = span_totals().get("jpeg.decode")
    return t["threads"] / t["count"] if t and "threads" in t else None
