"""Weight bridge: Flax ``{"params", "batch_stats"}`` trees of numpy arrays
-> the port's state dict, and back (``state_dict_to_flax``).

The names follow the Flax layout of the JAX package (``models/resnet.py``;
``checkpoint.py::_map_flax_path``), where ``blockB/unit_U`` is ONE key:

    params/resnet/<conv>/kernel (HWIO)          -> resnet.<conv>.weight (OIHW)
    params/resnet/<x>_bn/{scale,bias}           -> resnet.<x>_bn.{weight,bias}
    batch_stats/resnet/<x>_bn/{mean,var}        -> resnet.<x>_bn.running_{mean,var}
    params/resnet/blockB/unit_U/<conv>[_bn]/... -> resnet.blockB/unit_U.<conv>[_bn]...
    params/head/{attn_w,attn_b,sal_w,sal_b}     -> head.<same>, same shapes
    params/head/logits/{kernel (F,C), bias}     -> head.logits.{weight (C,F), bias}
    params/pose_head/pose_conv/{kernel, bias}   -> pose_head.pose_conv.{weight, bias}

A key that maps to nothing, or a parameter of the model that no key fills,
raises.  Trees shaped like ``params`` (optimizer momentum, a parameter
EMA) map by the same rules: ``flax_to_state_dict(tree)``.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from attentionalpoolingaction_torch.models.resnet import BACKBONES

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_HEAD_PARAMS = ("attn_w", "attn_b", "sal_w", "sal_b")


def _leaves(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _hwio_to_oihw(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (3, 2, 0, 1))


def _oihw_to_hwio(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0))


def _map(coll: str, path: tuple, value: np.ndarray):
    """(port key, array) for one Flax leaf; raises on an unknown path."""
    where = f"{coll}/{'/'.join(path)}"
    *mods, leaf = path
    if coll == "batch_stats":
        if mods and mods[0] == "resnet" and mods[-1].endswith("_bn") \
                and leaf in _BN_STATS:
            return ".".join(mods + [_BN_STATS[leaf]]), value
        raise KeyError(f"no port parameter for {where}")
    if coll != "params" or not mods:
        raise KeyError(f"no port parameter for {where}")
    if mods[0] == "resnet" and len(mods) >= 2:
        if mods[-1].endswith("_bn") and leaf in _BN_PARAMS:
            return ".".join(mods + [_BN_PARAMS[leaf]]), value
        if not mods[-1].endswith("_bn") and leaf == "kernel":
            return ".".join(mods + ["weight"]), _hwio_to_oihw(value)
    elif mods == ["head"] and leaf in _HEAD_PARAMS:
        return f"head.{leaf}", value
    elif mods == ["head", "logits"]:
        if leaf == "kernel":
            return "head.logits.weight", value.T
        if leaf == "bias":
            return "head.logits.bias", value
    elif mods == ["pose_head", "pose_conv"]:
        if leaf == "kernel":
            return "pose_head.pose_conv.weight", _hwio_to_oihw(value)
        if leaf == "bias":
            return "pose_head.pose_conv.bias", value
    raise KeyError(f"no port parameter for {where}")


def flax_to_state_dict(params: Mapping, batch_stats: Mapping | None = None
                       ) -> dict[str, torch.Tensor]:
    """The port's state dict (CPU float32 tensors) from Flax trees of
    arrays (anything ``np.asarray`` takes)."""
    batch_stats = batch_stats or {}
    out = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            key, arr = _map(coll, path, np.asarray(value, np.float32))
            out[key] = torch.from_numpy(np.array(arr, np.float32))  # a copy
    return out


_BN_LEAVES = {**{v: ("params", k) for k, v in _BN_PARAMS.items()},
              **{v: ("batch_stats", k) for k, v in _BN_STATS.items()}}


def _unmap(key: str, value: np.ndarray):
    """(collection, Flax path, array) for one port key, the inverse of
    :func:`_map`; None for ``num_batches_tracked``.  Raises on a key that
    has no Flax counterpart."""
    *mods, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if mods and mods[0] == "resnet" and len(mods) >= 2:
        if mods[-1].endswith("_bn"):
            if leaf in _BN_LEAVES:
                coll, name = _BN_LEAVES[leaf]
                return coll, tuple(mods + [name]), value
        elif leaf == "weight":
            return "params", tuple(mods + ["kernel"]), _oihw_to_hwio(value)
    elif mods == ["head"] and leaf in _HEAD_PARAMS:
        return "params", ("head", leaf), value
    elif mods == ["head", "logits"] and leaf == "weight":
        return "params", ("head", "logits", "kernel"), value.T
    elif mods == ["pose_head", "pose_conv"] and leaf == "weight":
        return "params", ("pose_head", "pose_conv", "kernel"), \
            _oihw_to_hwio(value)
    elif mods in (["head", "logits"], ["pose_head", "pose_conv"]) \
            and leaf == "bias":
        return "params", (*mods, "bias"), value
    raise KeyError(f"no Flax variable for port key {key}")


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> tuple[dict, dict]:
    """Flax-layout ``(params, batch_stats)`` trees of float32 numpy arrays
    (copies) from the port's state dict, or from a dict of parameters by
    name (an EMA); the inverse of :func:`flax_to_state_dict`."""
    trees: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        mapped = _unmap(key, t.detach().to("cpu", torch.float32).numpy())
        if mapped is None:
            continue
        coll, path, arr = mapped
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr, np.float32)   # a contiguous copy
    return trees["params"], trees["batch_stats"]


def load_flax_variables(model: torch.nn.Module, params: Mapping,
                        batch_stats: Mapping) -> torch.nn.Module:
    """Copy Flax variables into ``model`` in place (strict: a parameter or
    statistic that no Flax leaf fills raises)."""
    sd = flax_to_state_dict(params, batch_stats)
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):   # no Flax counterpart
            sd[key] = torch.zeros_like(t, device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def random_flax_variables(backbone: str, *, num_classes: int,
                          rank: int = 1, num_positions: int = 49,
                          pooling: str = "attention", num_joints: int = 16,
                          seed: int = 0) -> tuple[dict, dict]:
    """Random (params, batch_stats) of an attention-pooling model in the
    Flax layout, from a numpy seed: fan-in-scaled convs, BN scale 1 and
    bias 0 with running mean 0 and var 1, head weights of std (n*f)^-1/2,
    and with ``pooling="pose_attention"`` the pose head's 1x1 conv
    (``num_joints`` + 1 channels).  Stands in for a trained checkpoint
    where none is at hand."""
    if pooling not in ("attention", "pose_attention"):
        raise ValueError(f"no random variables for pooling {pooling!r}")
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def conv(kh, kw, cin, cout, gain=2.0):
        std = np.sqrt(gain / (kh * kw * cin))
        return (rng.standard_normal((kh, kw, cin, cout)) * std).astype(f32)

    def bn(p_tree, s_tree, name, ch):
        p_tree[name] = {"scale": np.ones(ch, f32), "bias": np.zeros(ch, f32)}
        s_tree[name] = {"mean": np.zeros(ch, f32), "var": np.ones(ch, f32)}

    res_p, res_s = {}, {}
    # the root conv is scaled down further so that the features of uint8
    # images (minus the VGG means) have std ~1, and the softmax over the
    # logits is not saturated
    res_p["conv1"] = {"kernel": conv(7, 7, 3, 64, gain=2.0 / 400 ** 2)}
    bn(res_p, res_s, "conv1_bn", 64)
    stage_sizes = BACKBONES[backbone].keywords["stage_sizes"]
    depth_in = 64
    for b, units in enumerate(stage_sizes, start=1):
        base = 64 * 2 ** (b - 1)
        for u in range(1, units + 1):
            up, us = {}, {}
            if depth_in != base * 4:
                up["shortcut"] = {"kernel": conv(1, 1, depth_in, base * 4)}
                bn(up, us, "shortcut_bn", base * 4)
            up["conv1"] = {"kernel": conv(1, 1, depth_in, base)}
            bn(up, us, "conv1_bn", base)
            up["conv2"] = {"kernel": conv(3, 3, base, base)}
            bn(up, us, "conv2_bn", base)
            # a small last conv keeps the residual sum from growing with
            # depth through identity batch norms
            up["conv3"] = {"kernel": conv(1, 1, base, base * 4, gain=0.1)}
            bn(up, us, "conv3_bn", base * 4)
            res_p[f"block{b}/unit_{u}"] = up
            res_s[f"block{b}/unit_{u}"] = us
            depth_in = base * 4

    feat = depth_in
    std = (num_positions * feat) ** -0.5
    head = {
        "attn_w": (rng.standard_normal((feat, num_classes, rank))
                   * std).astype(f32),
        "attn_b": (rng.standard_normal((num_classes, rank))
                   * 0.01).astype(f32),
        "sal_w": (rng.standard_normal((feat, rank)) * std).astype(f32),
        "sal_b": (rng.standard_normal(rank) * 0.01).astype(f32),
    }
    params = {"resnet": res_p, "head": head}
    if pooling == "pose_attention":
        params["pose_head"] = {"pose_conv": {
            "kernel": conv(1, 1, feat, num_joints + 1, gain=1.0),
            "bias": np.zeros(num_joints + 1, f32)}}
    return params, {"resnet": res_s}
