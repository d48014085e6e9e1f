"""The data-parallel step's share of its cards' peak over the window: 3x
the forward FLOPs of an image (forward and backward) times the window's
images, over the window's seconds and the peak of every card of the
mesh (``cards`` times the configuration's peak, bf16 here)."""


def read(ctx):
    if not ctx.get("images") or not ctx.get("window_s") or not ctx.get(
            "cards"):
        return None
    return (100.0 * ctx["images"] * ctx["train_flops"] / ctx["window_s"]
            / (ctx["cards"] * ctx["peak_flops"]))
