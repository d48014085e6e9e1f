"""Plain reference of a training step with frozen batch norm, data-parallel
over ``blocks`` of rows: what ``reference/train.py`` does, but for the
configurations that fine-tune with ``freeze_bn`` (BASELINE config #5,
``mpii_rank5_450_mesh``).

* Batch norm normalizes with the running statistics (``model.logits(...,
  train=False)``) under autograd: the gradients reach its scale and
  offset, and the statistics never move.
* The loss is softmax cross entropy, the mean over the global batch.
* The batch is computed in blocks of rows (the ranks' rows, in rank
  order), each block's summed loss over the global row count, and the
  blocks' gradients are summed.  With frozen batch norm no row sees
  another, so the sum is the whole batch's gradient; the blocks only keep
  a 450 px ResNet-101 within one card.
* Then the global-norm clip, weight decay on the decayed leaves, and SGD
  with momentum at the staircase exponential rate, and the EMA where the
  configuration has one: ``reference/train.py``'s ``Trainer.apply``.

Departures from the paper's description (arXiv 1711.01467, section 4,
and the configuration as BASELINE.json states it): the computation is
float32 (the caller turns TF32 off: ``model.exact_float32``) where the
configuration runs a bfloat16 backbone; the weights are the benchmark's
seeded ones, not an ImageNet checkpoint; the global batch is the cell's
32 rows on 4 blocks, not the deployment's 64 on 8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import model as ref_model
from bench_h100.reference.train import Trainer, _rebuild


class FrozenTrainer(Trainer):
    """``reference/train.py``'s trainer with batch norm frozen and the
    batch taken in ``blocks`` equal blocks of rows."""

    def __init__(self, params, stats, recipe, blocks: int = 1):
        super().__init__(params, stats, recipe)
        self.blocks = int(blocks)

    def block_loss_and_grads(self, images_u8, labels, rows: int,
                             dtype=torch.float32):
        """One block's loss, summed over its rows and divided by ``rows``
        (the global count), and its gradients."""
        leaves = {p: t.requires_grad_(True) for p, t in self.params.items()}
        logits, _ = ref_model.logits(
            _rebuild(leaves.items()), _rebuild(self.stats.items()),
            images_u8, stages=self.recipe.stages, train=False, dtype=dtype)
        loss = F.cross_entropy(logits, labels, reduction="sum") / rows
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for t in leaves.values():
            t.requires_grad_(False)
        return loss.detach(), {
            p: (g if g is not None else torch.zeros_like(leaves[p]))
            for p, g in zip(leaves, grads)}

    def loss_and_grads(self, images_u8, labels, dtype=torch.float32):
        """The global batch's mean loss and its gradients, block by block;
        no running statistic moves (the updates are empty)."""
        rows = int(labels.shape[0])
        if rows % self.blocks:
            raise ValueError(f"{rows} rows do not split into "
                             f"{self.blocks} blocks")
        size = rows // self.blocks
        total, grads = 0.0, None
        for k in range(self.blocks):
            part = slice(k * size, (k + 1) * size)
            loss, g = self.block_loss_and_grads(images_u8[part],
                                                labels[part], rows, dtype)
            total = total + loss
            grads = g if grads is None else {
                p: grads[p] + g[p] for p in grads}
        return total, grads, {}
