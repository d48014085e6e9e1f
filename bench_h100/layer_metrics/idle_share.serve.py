"""Share of the traced part of the window in which no kernel, copy or
set ran on the card (``torch.profiler``)."""


def read(ctx):
    t = ctx.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
