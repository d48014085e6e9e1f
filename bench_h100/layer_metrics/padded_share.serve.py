"""Share of the dispatched rows that were bucket padding over the window:
``serving_padded_items_total`` over padded plus real items."""


def read(ctx):
    c = ctx.get("counters") or {}
    items = c.get("serving_items_total", 0.0)
    pad = c.get("serving_padded_items_total", 0.0)
    return 100.0 * pad / (items + pad) if items + pad > 0 else None
