"""The train step's share of the chip's peak over the window: 3x the
forward FLOPs of an image (forward and backward; recompute not counted)
times the window's images, over the window's seconds and the
configuration's peak."""


def read(ctx):
    if not ctx.get("images") or not ctx.get("window_s"):
        return None
    return (100.0 * ctx["images"] * ctx["train_flops"] / ctx["window_s"]
            / ctx["peak_flops"])
