"""The head's kernels' share of their roofline in the traced steps: the
least time of every ``saliency_summary``, ``project_logits`` and
``pool_backward`` launch (the larger of its bytes over HBM's rate and its
FLOPs over the float32 peak, ``roofline.py``) over their device time in
the trace."""

from bench_h100 import roofline


def read(ctx):
    t = ctx.get("trace")
    shape = ctx.get("head_shape")
    if t is None or not shape:
        return None
    least = spent = 0.0
    for name, cost in roofline.HEAD_KERNELS.items():
        n, s = t.kernel_time(name)
        if not n:
            continue
        nbytes, flops = cost(shape["b"], shape["n"], shape["f"],
                             shape["c"], shape["p"], shape["x_bytes"])
        least += n * roofline.least_seconds(nbytes, flops)
        spent += s
    return 100.0 * least / spent if spent > 0 else None
