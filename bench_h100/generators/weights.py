"""Seeded weights of a configuration's model, made on its device in a few
large calls, in the Flax layout that both the port and the plain
reference take.

The scheme is that of the port's seeded stand-in for a trained
checkpoint: fan-in-scaled convs (the last conv of a unit and its batch
norm's scale small, so that each unit starts near the identity; the
root's running variance large, so that eval mode normalizes the root's
output to ~1), head
weights of std (n f)^-1/2, and batch norms with drawn scales, offsets,
means and variances, so that eval-mode normalization has something to
do.  One ``torch.Generator`` on the device draws all of it: one normal
draw for every kernel and head weight, one uniform and one normal draw
for the batch norms.  The same seed gives the same weights on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

# the ResNet-v1 layout is the yardstick's (roofline.py counts its FLOPs)
from bench_h100.roofline import NUM_FEATURES, STAGES, feature_size

# the root batch norm's running variance is this many times its drawn
# one: mean-subtracted uint8 pixels (std ~60) through a fan-in-scaled 7x7
# conv have a variance of that order, so that eval mode normalizes the
# root's output to ~1 as a trained network's statistics do
ROOT_VARIANCE = 400.0 ** 2
# the last batch norm of each residual unit scales by a tenth of the
# others (Goyal et al. 2017 start it at zero): each unit starts near the
# identity, as in a trained network.  With scales ~1 a random ResNet is
# chaotic in train mode (float32 and float64 steps differ by ~0.5% in the
# worst leaf's gradient) and its sensitivity in eval mode moves 5x from
# seed to seed, so no comparison could tell float32 from bfloat16 (the
# cells' control)
RESIDUAL_SCALE = 0.1


def layout(backbone: str, *, num_classes: int, rank: int,
           image_size: int):
    """``(kernels, norms)``: each kernel or head weight as (path, shape,
    std) and each batch norm as (path to its module, channels), in the
    model's order; a path is a tuple of keys of the Flax tree."""
    kernels, norms = [], []

    def conv(path, kh, kw, cin, cout, gain=2.0):
        kernels.append((path + ("kernel",), (kh, kw, cin, cout),
                        float(np.sqrt(gain / (kh * kw * cin)))))

    conv(("resnet", "conv1"), 7, 7, 3, 64)
    norms.append((("resnet", "conv1_bn"), 64))
    depth_in = 64
    for b, units in enumerate(STAGES[backbone], start=1):
        base = 64 * 2 ** (b - 1)
        for u in range(1, units + 1):
            unit = ("resnet", f"block{b}/unit_{u}")
            if depth_in != base * 4:
                conv(unit + ("shortcut",), 1, 1, depth_in, base * 4)
                norms.append((unit + ("shortcut_bn",), base * 4))
            conv(unit + ("conv1",), 1, 1, depth_in, base)
            norms.append((unit + ("conv1_bn",), base))
            conv(unit + ("conv2",), 3, 3, base, base)
            norms.append((unit + ("conv2_bn",), base))
            conv(unit + ("conv3",), 1, 1, base, base * 4, gain=0.1)
            norms.append((unit + ("conv3_bn",), base * 4))
            depth_in = base * 4
    n = feature_size(image_size) ** 2
    std = float((n * NUM_FEATURES) ** -0.5)
    kernels += [(("head", "attn_w"), (NUM_FEATURES, num_classes, rank), std),
                (("head", "attn_b"), (num_classes, rank), 0.01),
                (("head", "sal_w"), (NUM_FEATURES, rank), std),
                (("head", "sal_b"), (rank,), 0.01)]
    return kernels, norms


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(backbone: str, *, num_classes: int, rank: int, image_size: int,
         seed: int, device) -> tuple[dict, dict]:
    """Flax-layout ``(params, batch_stats)`` of float32 tensors on
    ``device`` from ``seed``."""
    kernels, norms = layout(backbone, num_classes=num_classes, rank=rank,
                            image_size=image_size)
    g = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(int(np.prod(s)) for _, s, _ in kernels)
    flat = torch.randn(total, generator=g, device=device)
    channels = sum(c for _, c in norms)
    uni = torch.rand(2, channels, generator=g, device=device)
    nrm = torch.randn(2, channels, generator=g, device=device)
    params, stats = {}, {}
    at = 0
    for path, shape, std in kernels:
        k = int(np.prod(shape))
        _put(params, path, flat[at:at + k].view(shape).mul_(std))
        at += k
    at = 0
    for path, c in norms:
        sl = slice(at, at + c)
        scale = uni[0, sl].mul(0.4).add_(0.8)
        if path[-1] == "conv3_bn":
            scale.mul_(RESIDUAL_SCALE)
        _put(params, path + ("scale",), scale)
        _put(params, path + ("bias",), nrm[0, sl].mul(0.1))
        _put(stats, path + ("mean",), nrm[1, sl].mul(0.1))
        var = uni[1, sl].mul(1.5).add_(0.5)
        if path == ("resnet", "conv1_bn"):
            var.mul_(ROOT_VARIANCE)
        _put(stats, path + ("var",), var)
        at += c
    return params, stats


def leaves(tree: dict, prefix=()) -> list:
    """``[(path, tensor)]`` of a tree, in insertion order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def to_numpy(tree: dict) -> dict:
    """A copy of ``tree`` as float32 numpy arrays on the host (what the
    port's weight bridge takes)."""
    return {k: (to_numpy(v) if isinstance(v, dict)
                else v.detach().to("cpu", torch.float32).numpy())
            for k, v in tree.items()}


def port_name_to_path(name: str) -> tuple[str, tuple]:
    """The collection and Flax path of one of the port's parameter or
    buffer names (``resnet.block1/unit_1.conv1.weight`` ->
    ``("params", ("resnet", "block1/unit_1", "conv1", "kernel"))``);
    ``("", ())`` for a name with no Flax leaf."""
    *mods, last = name.split(".")
    if mods and mods[0] == "head":
        return "params", ("head", last)
    if mods and mods[-1].endswith("_bn"):
        leaf = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}.get(last)
        if leaf is None:
            return "", ()
        return leaf[0], tuple(mods) + (leaf[1],)
    if last == "weight":
        return "params", tuple(mods) + ("kernel",)
    return "", ()
