"""Host-clock milliseconds an image waited for a thread of the server's
decode pool, from its submission to the start of its decode: the mean of
the port's ``serve.decode_wait`` spans (``utils/profiling.py``) over
the traced part of the window."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    t = span_totals().get("serve.decode_wait")
    return 1e3 * t["seconds"] / t["count"] if t else None
