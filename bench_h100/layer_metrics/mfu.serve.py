"""The forward's share of the chip's peak over the window: the forward
FLOPs of every dispatched row (padding included: the chip computes it),
counted from shapes (``roofline.forward_flops``), over
``serving_device_seconds_sum``, over the configuration's peak."""


def read(ctx):
    c = ctx.get("counters") or {}
    secs = c.get("serving_device_seconds_sum", 0.0)
    rows = c.get("serving_items_total", 0.0) + c.get(
        "serving_padded_items_total", 0.0)
    if secs <= 0 or rows <= 0:
        return None
    return 100.0 * rows * ctx["forward_flops"] / secs / ctx["peak_flops"]
