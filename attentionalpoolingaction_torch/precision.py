"""How far apart two correct train steps of the port can land.

``--mode f64`` (the default): one step of an attention-pooling config in
float32 (the port's step) and in float64 (the same model and update, the
head by plain einsums), from the same seeded weights in the Flax layout
and the same seeded batch, TF32 off.

``--mode bf16``: the bfloat16 backbone (``bf16_backbone=True``) against
the float32 one, from the same weights and batch: the eval-mode forward
and one train step, TF32 off.

    python3 -m attentionalpoolingaction_torch.precision [--mode f64|bf16]
        [--device cpu] [--seeds 0 1 2] [--preset mpii_rank1_224]
        [--backbone resnet_v1_101] [--image_size 224] [--batch_size 8]

Runs on the card unless ``--device`` names another.  Prints one JSON line
a seed (the seed draws both the weights and the batch).

float64 mode: the relative differences of the loss and ``grad_norm``, the
largest relative difference of the features, the worst per-leaf and the
overall L2 difference of the momentum buffers (the clipped gradient plus
the decay) and of the pooling head's, the largest difference of a BN
statistic's change relative to its largest change, and the leaves that
carry most of ``grad_norm`` (their share of its square).  Train-mode
batch norm grows float32 rounding with depth; these numbers set the
tolerances of ``chip_smoke.py`` phase 4 (card vs CPU) and of
``tests/test_torch_train_step.py`` (port vs JAX).

bfloat16 mode (:func:`bf16_gap`): the L2 relative differences of the
eval-mode features and logits, the relative differences of each loss and
of ``grad_norm``, the L2 differences of the momentum buffers over all
leaves and of the BN statistics' changes (BN in train mode).  These set
the bfloat16 tolerances of ``chip_smoke.py`` (card vs CPU) and are what
``tests/test_torch_bf16.py`` measures on each side of port vs JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert, train
from attentionalpoolingaction_torch.device import resolve_device


def step64(cfg, variables, batch, device):
    """One step in float64: the port's model and update; the pooling head
    by the factorized einsums (its kernels take float32).  Also returns
    each leaf's squared gradient norm before the clip."""
    model = train.build_model(cfg, device=device)
    convert.load_flax_variables(model, *variables)
    model.double().train()
    model.resnet.dtype = torch.float64
    images = train.normalize_images(torch.from_numpy(batch["image"]).to(
        device))
    feats = model.resnet(images.double().permute(0, 3, 1, 2),
                         global_pool=False).permute(0, 2, 3, 1)
    b, h, w, f = feats.shape
    x = feats.reshape(b, h * w, f)
    head = model.head
    s = torch.einsum("bnf,fp->bnp", x, head.sal_w) + head.sal_b
    v = torch.einsum("bnf,bnp->bfp", x, s)
    logits = (torch.einsum("bfp,fcp->bc", v, head.attn_w)
              + torch.einsum("bp,cp->bc", s.sum(1), head.attn_b))
    loss = train.classification_loss(
        logits, torch.from_numpy(batch["label"]).to(device),
        multi_label=False, label_smoothing=cfg.label_smoothing)
    loss.backward()
    grad_sq = {n: float(p.grad.square().sum())
               for n, p in model.named_parameters() if p.grad is not None}
    state = train.TrainState(step=0, model=model,
                             optimizer=train.make_optimizer(cfg, model))
    norm = train.apply_gradients(state, cfg, train.make_learning_rate(cfg))
    return state, feats.detach(), float(loss.detach()), float(norm), grad_sq


def measure(preset, cfg, seed, device):
    """The JSON-able differences of one seed's float32 step from its
    float64 step, both on ``device``."""
    fs = train.feature_size(cfg.image_size)
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=train.get_dataset(cfg.dataset).num_classes,
        rank=cfg.rank, num_positions=fs * fs, seed=seed)
    rng = np.random.default_rng(seed)
    size = cfg.image_size
    batch = {"image": rng.integers(0, 256, (cfg.batch_size, size, size, 3),
                                   np.uint8),
             "label": rng.integers(0, 393, cfg.batch_size).astype(np.int64)}

    state, _ = train.create_state(cfg, device=device, variables=variables)
    stats0 = {k: v.clone().double() for k, v in
              state.model.state_dict().items() if "running" in k}
    _, m = train.make_train_step(train.get_dataset(cfg.dataset), cfg)(
        state, train.batch_to_device(batch, device))
    ref, feats64, loss64, norm64, grad_sq = step64(cfg, variables, batch,
                                                   device)

    # the float32 features of the same initial weights, train mode
    model32 = train.build_model(cfg, device=device)
    convert.load_flax_variables(model32, *variables)
    with torch.no_grad():
        f32 = model32.train().resnet(
            train.normalize_images(torch.from_numpy(batch["image"]).to(
                device)).permute(0, 3, 1, 2),
            global_pool=False).permute(0, 2, 3, 1)

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    def l2(a, b):
        return float((a.double() - b).norm() / b.norm())

    named32 = dict(state.model.named_parameters())
    leaf, head, sq_err, sq_ref = 0.0, 0.0, 0.0, 0.0
    for n, p in ref.model.named_parameters():
        want = ref.optimizer.state[p]["momentum_buffer"]
        got = state.optimizer.state[named32[n]]["momentum_buffer"].double()
        if n.startswith("head."):
            head = max(head, l2(got, want))
        else:
            leaf = max(leaf, l2(got, want))
        sq_err += float(((got - want) ** 2).sum())
        sq_ref += float((want ** 2).sum())
    stats32 = {k: v.double() for k, v in state.model.state_dict().items()
               if "running" in k}
    stats64 = {k: v for k, v in ref.model.state_dict().items()
               if "running" in k}
    stat = max(rel(stats32[k] - stats0[k], stats64[k] - stats0[k])
               for k in stats0)
    total_sq = sum(grad_sq.values())
    top = sorted(grad_sq.items(), key=lambda kv: -kv[1])[:3]
    return {
        "config": {"preset": preset, "backbone": cfg.backbone,
                   "image_size": size, "batch_size": cfg.batch_size},
        "seed": seed, "device": str(device),
        "threads": torch.get_num_threads(),
        "loss_rel": abs(float(m["loss/total"]) - loss64) / abs(loss64),
        "grad_norm_rel": abs(float(m["grad_norm"]) - norm64) / norm64,
        "grad_norm": norm64,
        "grad_norm_top_leaves": [[n, sq / total_sq] for n, sq in top],
        "features_rel": rel(f32, feats64),
        "momentum_worst_leaf_l2": leaf, "momentum_head_l2": head,
        "momentum_total_l2": (sq_err / sq_ref) ** 0.5,
        "bn_stat_change_rel": stat}


def synthetic_batch(rng, cfg, spec) -> dict:
    """A seeded numpy batch of ``cfg``'s shape: uint8 images ((B, T, S, S,
    3) with ``clip_frames`` > 1), labels (multi-hot for a multi-label
    dataset) and, for pose attention, the crop transform, keypoints and
    visibility."""
    b, size = cfg.batch_size, cfg.image_size
    frames = (cfg.clip_frames,) if cfg.clip_frames > 1 else ()
    batch = {"image": rng.integers(0, 256, (b, *frames, size, size, 3),
                                   np.uint8)}
    if spec.multi_label:
        batch["label"] = (rng.uniform(size=(b, spec.num_classes))
                          < 0.01).astype(np.float32)
    else:
        batch["label"] = rng.integers(0, spec.num_classes, b).astype(
            np.int32)
    if cfg.pooling == "pose_attention":
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(0, 8, b), rng.uniform(0, 8, b),
             (np.arange(b) % 2).astype(np.float64)], 1).astype(np.float32)
        batch["keypoints"] = rng.uniform(
            0, size, (b, spec.num_joints, 2)).astype(np.float32)
        batch["visibility"] = (rng.uniform(size=(b, spec.num_joints))
                               > 0.2).astype(np.float32)
    return batch


def seeded_variables(cfg, seed: int):
    """Flax-layout (params, batch_stats) of ``cfg``'s model from ``seed``
    (``convert.random_flax_variables``)."""
    fs = train.feature_size(cfg.image_size)
    spec = train.get_dataset(cfg.dataset)
    return convert.random_flax_variables(
        cfg.backbone, num_classes=spec.num_classes, rank=cfg.rank,
        num_positions=fs * fs, pooling=cfg.pooling,
        num_joints=spec.num_joints, seed=seed)


def _bf16_side(cfg, variables, batch, device):
    """The eval-mode features and logits and one train step of ``cfg``
    on ``device``, from ``variables``."""
    state, spec = train.create_state(cfg, device=device,
                                     variables=variables)
    model = state.model
    dev_batch = train.batch_to_device(batch, device)
    with torch.no_grad():
        out = model.eval()(train.normalize_images(dev_batch["image"]))
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    _, m = train.make_train_step(spec, cfg)(state, dev_batch)
    opt = state.optimizer
    return {
        "features": out["features"].double().cpu(),
        "logits": out["logits"].double().cpu(),
        "metrics": {k: float(v) for k, v in m.items()},
        "momentum": [opt.state[p]["momentum_buffer"].double().cpu()
                     for p in model.parameters() if p in opt.state],
        "stat_change": [(v - stats0[k]).double().cpu()
                        for k, v in model.state_dict().items()
                        if "running" in k]}


def bf16_gap(cfg, variables, batch, device) -> dict:
    """The gap of the bfloat16 backbone from the float32 one on
    ``device``: the same ``variables`` and numpy ``batch``, the eval-mode
    forward and one train step each.  Relative differences (L2 for
    tensors) of the bfloat16 side from the float32 one; ``bn_stat_change``
    is None with the batch norms frozen."""
    f32, bf16 = (_bf16_side(dataclasses.replace(cfg, bf16_backbone=bf),
                            variables, batch, device)
                 for bf in (False, True))

    def l2(got, want):
        num = sum(float((g - w).square().sum()) for g, w in zip(got, want))
        den = sum(float(w.square().sum()) for w in want)
        return (num / den) ** 0.5 if den else None

    gap = {"features_l2": l2([bf16["features"]], [f32["features"]]),
           "logits_l2": l2([bf16["logits"]], [f32["logits"]]),
           "momentum_total_l2": l2(bf16["momentum"], f32["momentum"]),
           "bn_stat_change_l2": l2(bf16["stat_change"], f32["stat_change"]),
           "f32_metrics": f32["metrics"], "bf16_metrics": bf16["metrics"]}
    for k, want in f32["metrics"].items():
        gap[f"{k}_rel"] = abs(bf16["metrics"][k] - want) / abs(want)
    return gap


def measure_bf16(preset, cfg, seed, device):
    """The JSON-able gap of one seed's bfloat16 step from its float32
    step, both on ``device``."""
    spec = train.get_dataset(cfg.dataset)
    batch = synthetic_batch(np.random.default_rng(seed), cfg, spec)
    gap = bf16_gap(cfg, seeded_variables(cfg, seed), batch, device)
    return {"config": {"preset": preset, "backbone": cfg.backbone,
                       "image_size": cfg.image_size,
                       "batch_size": cfg.batch_size,
                       "clip_frames": cfg.clip_frames,
                       "freeze_bn": cfg.freeze_bn},
            "mode": "bf16", "seed": seed, "device": str(device),
            "threads": torch.get_num_threads(), **gap}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="mpii_rank1_224")
    parser.add_argument("--backbone")
    parser.add_argument("--image_size", type=int)
    parser.add_argument("--batch_size", type=int)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--device", help="default: cuda")
    parser.add_argument("--mode", choices=("f64", "bf16"), default="f64")
    args = parser.parse_args()
    overrides = {k: getattr(args, k) for k in
                 ("backbone", "image_size", "batch_size")
                 if getattr(args, k) is not None}
    cfg = config_lib.get_config(args.preset, **overrides)
    if args.mode == "f64" and cfg.pooling != "attention":
        raise SystemExit("the float64 step covers attention pooling only")
    if args.mode == "f64":
        cfg = dataclasses.replace(cfg, bf16_backbone=False)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = measure_bf16 if args.mode == "bf16" else measure
    for seed in args.seeds:
        print(json.dumps(run(args.preset, cfg, seed, device)), flush=True)


if __name__ == "__main__":
    main()
