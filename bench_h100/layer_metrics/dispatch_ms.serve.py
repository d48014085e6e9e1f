"""Host-clock milliseconds a device dispatch over the window:
``serving_device_seconds_sum`` over ``serving_device_dispatches_total``
(it ends in the device-to-host copy of the logits)."""


def read(ctx):
    c = ctx.get("counters") or {}
    n = c.get("serving_device_dispatches_total", 0.0)
    return 1e3 * c.get("serving_device_seconds_sum", 0.0) / n if n else None
