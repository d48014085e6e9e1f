"""Milliseconds a traced step in which rank 0's card runs an NCCL kernel
and no other kernel, copy or set: the exchange the device leaves
exposed, its wait for the other ranks included (``nccl_exposed_s``, read
from rank 0's trace by ``drivers/train_mesh.nccl_exposed_seconds``, over
the traced steps)."""


def read(ctx):
    s, steps = ctx.get("nccl_exposed_s"), ctx.get("traced_steps")
    if ctx.get("trace") is None or s is None or not steps:
        return None
    return 1e3 * s / steps
