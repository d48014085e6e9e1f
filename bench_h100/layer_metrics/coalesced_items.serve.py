"""Items a device dispatch over the window: ``serving_items_total`` over
``serving_device_dispatches_total`` (``ServingStats``), their deltas."""


def read(ctx):
    c = ctx.get("counters") or {}
    n = c.get("serving_device_dispatches_total", 0.0)
    return c.get("serving_items_total", 0.0) / n if n > 0 else None
