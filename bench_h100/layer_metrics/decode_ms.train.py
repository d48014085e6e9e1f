"""Host-clock milliseconds of the byte path an image: the port's
``jpeg.decode`` spans (nvJPEG's host work and the colour kernel's launch,
``utils/profiling.py``) over the traced steps, their seconds over their
images."""


def read(ctx):
    if ctx.get("trace") is None:
        return None
    try:
        from attentionalpoolingaction_torch.utils.profiling import (
            span_totals)
    except ImportError:         # a port that keeps no spans
        return None
    t = span_totals().get("jpeg.decode")
    return 1e3 * t["seconds"] / t["images"] if t and t["images"] else None
