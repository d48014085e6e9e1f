"""Plain reference of a training step: softmax cross entropy (mean over
the batch), autograd, the global-norm clip, then weight decay on the
decayed leaves (conv kernels, ``attn_w``, ``sal_w``), SGD with momentum
(``m = momentum * m + g``, the first ``m = g``; ``p -= lr * m``) at the
staircase exponential rate ``lr * rate ** (step // decay_steps)``, and an
EMA of the parameters (TF's, ``decay = min(decay, (1 + t) / (10 + t))``)
where the configuration has one; batch norm's running statistics move in
train mode.  The paper's recipe (arXiv 1711.01467, section 4) as the
configuration states it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from bench_h100.reference import model as ref_model


@dataclasses.dataclass
class Recipe:
    stages: tuple
    learning_rate: float
    momentum: float
    weight_decay: float
    lr_decay_rate: float
    lr_decay_steps: int
    grad_clip_norm: float | None
    ema_decay: float | None
    bn_decay: float


def decayed(path: tuple) -> bool:
    return path[-1] in ("kernel", "attn_w", "sal_w")


def _flatten(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flatten(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _rebuild(pairs):
    tree = {}
    for path, v in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


class Trainer:
    """The reference's training state: parameters, batch statistics,
    momentum and EMA, each a dict by Flax path."""

    def __init__(self, params, stats, recipe: Recipe):
        self.recipe = recipe
        self.params = {p: t.detach().clone() for p, t in _flatten(params)}
        self.stats = {p: t.detach().clone() for p, t in _flatten(stats)}
        self.momentum = {}
        self.ema = ({p: t.clone() for p, t in self.params.items()}
                    if recipe.ema_decay else None)
        self.step = 0

    def loss_and_grads(self, images_u8, labels, dtype=torch.float32):
        leaves = {p: t.requires_grad_(True) for p, t in self.params.items()}
        logits, updates = ref_model.logits(
            _rebuild(leaves.items()), _rebuild(self.stats.items()),
            images_u8, stages=self.recipe.stages, train=True,
            decay=self.recipe.bn_decay, dtype=dtype)
        loss = F.cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for t in leaves.values():
            t.requires_grad_(False)
        grads = {p: (g if g is not None else torch.zeros_like(leaves[p]))
                 for p, g in zip(leaves, grads)}
        return loss.detach(), grads, updates

    def apply(self, grads, updates):
        """One update from ``grads``; returns what the optimizer took in
        for each leaf (the clipped gradient plus the decay), which is its
        momentum after a first step."""
        r = self.recipe
        norm = torch.sqrt(sum(g.double().square().sum()
                              for g in grads.values())).float()
        scale = (torch.clamp(r.grad_clip_norm / norm, max=1.0)
                 if r.grad_clip_norm else torch.ones((), device=norm.device))
        lr = r.learning_rate * r.lr_decay_rate ** (self.step
                                                   // r.lr_decay_steps)
        taken = {}
        for p, g in grads.items():
            d = g * scale
            if decayed(p) and r.weight_decay:
                d = d + r.weight_decay * self.params[p]
            taken[p] = d
            m = self.momentum.get(p)
            m = d.clone() if m is None else r.momentum * m + d
            self.momentum[p] = m
            self.params[p] = self.params[p] - lr * m
        for path, (mean, var) in updates.items():
            self.stats[path + ("mean",)] = mean
            self.stats[path + ("var",)] = var
        self.step += 1
        if self.ema is not None:
            t = float(self.step)
            d = min(r.ema_decay, (1.0 + t) / (10.0 + t))
            for p in self.ema:
                self.ema[p] = d * self.ema[p] + (1.0 - d) * self.params[p]
        return taken, norm

    def train_step(self, images_u8, labels, dtype=torch.float32):
        loss, grads, updates = self.loss_and_grads(images_u8, labels, dtype)
        taken, norm = self.apply(grads, updates)
        return {"loss": float(loss), "grad_norm": float(norm),
                "grads": grads, "taken": taken}
