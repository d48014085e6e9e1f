"""Share of rank 0's traced part of the window in which no kernel, copy
or set ran on its card, as ``idle_share.train`` reads it."""

import pathlib

from bench_h100 import common


def read(ctx):
    root = pathlib.Path(__file__).resolve().parents[2]
    return common.load_reader(root, "idle_share.train")(ctx)
