"""How far apart two correct float32 train steps of the port can land: one
step of an attention-pooling config in float32 (the port's step) and in
float64 (the same model and update, the head by plain einsums), from the
same seeded weights in the Flax layout and the same seeded batch, TF32
off.

    python3 -m attentionalpoolingaction_torch.precision [--device cpu]
        [--seeds 0 1 2] [--preset mpii_rank1_224]
        [--backbone resnet_v1_101] [--image_size 224] [--batch_size 8]

Runs on the card unless ``--device`` names another.  Prints one JSON line
a seed (the seed draws both the weights and the batch): the relative
differences of the loss and ``grad_norm``, the largest relative
difference of the features, the worst per-leaf and the overall L2
difference of the momentum buffers (the clipped gradient plus the decay)
and of the pooling head's, the largest difference of a BN statistic's
change relative to its largest change, and the leaves that carry most of
``grad_norm`` (their share of its square).  Train-mode batch norm grows
float32 rounding with depth; these numbers set the tolerances of
``chip_smoke.py`` phase 4 (card vs CPU) and of
``tests/test_torch_train_step.py`` (port vs JAX).
"""

from __future__ import annotations

import argparse
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="mpii_rank1_224")
    parser.add_argument("--backbone")
    parser.add_argument("--image_size", type=int)
    parser.add_argument("--batch_size", type=int)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--device", help="default: cuda")
    args = parser.parse_args()
    overrides = {k: getattr(args, k) for k in
                 ("backbone", "image_size", "batch_size")
                 if getattr(args, k) is not None}
    cfg = config_lib.get_config(args.preset, **overrides)
    if cfg.pooling != "attention":
        raise SystemExit("the float64 step covers attention pooling only")
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        print(json.dumps(measure(args.preset, cfg, seed, device)),
              flush=True)


if __name__ == "__main__":
    main()
