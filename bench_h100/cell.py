"""What a cell's drivers share: the port's configuration of the cell,
held to its configuration file, and the cell's seeded weights."""

from __future__ import annotations

from bench_h100 import common
from bench_h100.generators import weights as gen_weights


def port_config(ctx: common.Context):
    """The port's ``TrainConfig`` of the cell, held to what the
    configuration file states (but for the keys a CPU test shrinks)."""
    from attentionalpoolingaction_torch import config as config_lib
    cf = ctx.config_file
    cfg = config_lib.get_config(cf["preset"], **cf.get("overrides", {}),
                                **ctx.shrink)
    for k, want in cf["config"].items():
        if k in ctx.shrink:
            continue
        got = (num_classes(cfg) if k == "num_classes" else
               getattr(cfg, f"{k}_resolved") if k in ("resize_min",
                                                       "resize_max")
               else getattr(cfg, k))
        if got != want:
            raise ValueError(f"{cf['preset']}: {k} is {got!r}, the "
                             f"configuration file states {want!r}")
    return cfg


def num_classes(cfg) -> int:
    from attentionalpoolingaction_torch.data.datasets import get_dataset
    return get_dataset(cfg.dataset).num_classes


def make_weights(cfg, seed: int, device):
    """The cell's seeded weights (``generators/weights.py``)."""
    return gen_weights.make(
        cfg.backbone, num_classes=num_classes(cfg), rank=cfg.rank,
        image_size=cfg.image_size, seed=seed, device=device)
