"""The head's kernels' share of their roofline in rank 0's traced steps,
as ``head_roofline.train`` reads it, at this cell's shape: 8 images a
card, N = 225 positions, F = 2048, C = 393, rank 5, float32 features (the
port casts them before the head whatever the backbone computes in)."""

import pathlib

from bench_h100 import common


def read(ctx):
    root = pathlib.Path(__file__).resolve().parents[2]
    return common.load_reader(root, "head_roofline.train")(ctx)
