"""The port's data-parallel train step of a rank-5 head with frozen batch
norm (BASELINE config #5's recipe, ``mpii_rank5_450_mesh``) against the
benchmark's plain reference of it (``bench_h100/reference/
train_frozen.py``: plain torch, no kernel of the port), on the CPU.

One spawn of two gloo ranks (``torch_spawn.py``) runs three steps of
``train.make_train_step`` on a mesh of the two, resnet_v1_50 at 64 px,
rank 5, float32 (the port's bfloat16 backbone runs on the card), from the
benchmark's seeded weights, each rank on its half of a global batch of 4
uint8 images; the reference takes the three global batches in two blocks
of the ranks' rows.  Tolerances, from what the two sides compute
differently: the port clips with the float32 norm of
``torch.nn.utils.get_total_norm``, which on the CPU reads the 4M-element
``attn_w`` gradient's norm ~2e-4 away from the reference's float64 norm
(measured: 1.5e-4 and 2.2e-4 on two seeds), so every leaf's step is
scaled alike by that much; three steps at the preset's rate on a random
ResNet (the loss rising 5.8 -> 7.5) carry it to 2e-4 in the loss and
to 7.6e-3 in the change of the worst leaf, a batch norm scale whose
three steps nearly cancel (median leaf 3e-4).  So, with ~10x room:

* the global loss of each step, 2e-3 relative;
* the momentum after step 1 (the clipped, all-reduced gradient plus the
  decay), in each leaf the reference's gradient moves, 2e-3 of the
  leaf's L2 norm;
* the parameters' change after step 3, in those leaves, 5e-3 of the
  leaf's norm in the median leaf and 5e-2 in the worst (a half batch or
  a skipped all-reduce moves the median leaf by 2-4%);

exactly: batch norm's running statistics do not move, both ranks hold the
same parameters (gloo hands every rank the same sum), and each step's
gradients go through one ``train.all_reduce`` span whose ``bytes`` are 4
times the gradients' elements.  A second case holds the reference's sum
over blocks to the unblocked batch.
"""

import pickle

import numpy as np
import pytest
import torch

from bench_h100.generators import weights as gen_weights
from bench_h100.reference import compare
from bench_h100.reference import model as ref_model
from bench_h100.reference.train import Recipe
from bench_h100.reference.train_frozen import FrozenTrainer
from torch_spawn import finish, start_workers

torch.set_num_threads(2)

SEED = 2 ** 31 + 18
CFG = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
           rank=5, image_size=64, batch_size=4, bf16_backbone=False,
           freeze_bn=True, learning_rate=0.01, mesh_shape=(2,))
CLASSES = 393
STEPS = 3
LOSS_RTOL = 2e-3
FIRST_RTOL = 2e-3
CHANGE_MEDIAN_RTOL = 5e-3
CHANGE_RTOL = 5e-2

WORKER = r"""
import pickle
import sys

import numpy as np
import torch

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.utils import profiling
from bench_h100.generators import weights as gen_weights

multihost.setup(f"127.0.0.1:{port}", n, rank, device="cpu")
with open(tmp + "/inputs.pkl", "rb") as f:
    cfg_kw, params, stats, batches = pickle.load(f)
cfg = config_lib.TrainConfig(**cfg_kw)
mesh = mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axes)
state, spec = train.create_state(cfg, device="cpu",
                                 variables=(params, stats), mesh=mesh)
step_fn = train.make_train_step(spec, cfg, mesh)


def by_leaf(tensors):
    out = {}
    for name, t in tensors:
        coll, path = gen_weights.port_name_to_path(name)
        if coll:
            out["/".join(path)] = t.detach().clone().numpy()
    return out


start = by_leaf(state.model.named_parameters())
stats0 = by_leaf(state.model.named_buffers())
losses, momentum = [], None
with profile(activities=[ProfilerActivity.CPU]):
    for images, labels in batches:
        rows = slice(rank * len(labels) // n, (rank + 1) * len(labels) // n)
        state, metrics = step_fn(state, {
            "image": torch.from_numpy(images[rows]),
            "label": torch.from_numpy(labels[rows])})
        losses.append(float(metrics["loss/total"]))
        if momentum is None:
            momentum = by_leaf(
                (name, state.optimizer.state[p]["momentum_buffer"])
                for name, p in state.model.named_parameters())
spans = [dict(s.ids) for s in profiling.spans()
         if s.name == "train.all_reduce"]
params = by_leaf(state.model.named_parameters())
with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
    pickle.dump({"losses": losses, "momentum": momentum, "start": start,
                 "params": params, "stats0": stats0,
                 "stats": by_leaf(state.model.named_buffers()),
                 "grad_elements": sum(p.numel() for p in
                                      state.model.parameters()),
                 "spans": spans}, f)
print(f"WORKER{rank} OK", flush=True)
"""


def recipe():
    return Recipe(stages=gen_weights.STAGES[CFG["backbone"]],
                  learning_rate=CFG["learning_rate"], momentum=0.9,
                  weight_decay=1e-4, lr_decay_rate=0.94,
                  lr_decay_steps=10_000, grad_clip_norm=10.0,
                  ema_decay=None, bn_decay=0.997)


def weights():
    return gen_weights.make(CFG["backbone"], num_classes=CLASSES,
                            rank=CFG["rank"], image_size=CFG["image_size"],
                            seed=SEED, device="cpu")


def make_batches():
    rng = np.random.default_rng(SEED)
    s, b = CFG["image_size"], CFG["batch_size"]
    return [(rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8),
             rng.integers(0, CLASSES, b).astype(np.int64))
            for _ in range(STEPS)]


def leaf_gaps(port: dict, ref: dict, keep) -> dict:
    """Each kept leaf's ``|port - ref| / |ref|`` in L2, the port's leaf
    brought to the Flax layout."""
    out = {}
    for k in keep:
        p = torch.from_numpy(port[k]).double()
        if p.dim() == 4:            # OIHW -> HWIO
            p = p.permute(2, 3, 1, 0)
        r = ref[k].double()
        out[k] = float(torch.linalg.vector_norm(p - r)
                       / torch.linalg.vector_norm(r))
    return out


def test_data_parallel_rank5_frozen_step_matches_the_reference(tmp_path):
    params, stats = weights()
    batches = make_batches()
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump((CFG, gen_weights.to_numpy(params),
                     gen_weights.to_numpy(stats), batches), f)
    procs = start_workers(WORKER, tmp_path, n=2)

    # the reference on the global batches, in the ranks' two blocks, while
    # the ranks run
    trainer = FrozenTrainer(params, stats, recipe(), blocks=2)
    init = {p: t.clone() for p, t in trainer.params.items()}
    stats0 = {p: t.clone() for p, t in trainer.stats.items()}
    losses = []
    with ref_model.exact_float32():
        for k, (images, labels) in enumerate(batches):
            r = trainer.train_step(torch.from_numpy(images),
                                   torch.from_numpy(labels))
            losses.append(r["loss"])
            if k == 0:
                taken = {"/".join(p): t for p, t in r["taken"].items()}
                keep = compare.moved_leaves(compare.norms(
                    {"/".join(p): g for p, g in r["grads"].items()}))
    change = {"/".join(p): trainer.params[p] - init[p] for p in init}
    assert all(torch.equal(trainer.stats[p], stats0[p]) for p in stats0)

    finish(procs, timeout=120)
    ranks = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    assert ranks[1]["losses"] == got["losses"]
    assert len(keep) > 100
    first = leaf_gaps(got["momentum"], taken, keep)
    assert max(first.values()) < FIRST_RTOL, max(first.items(),
                                                 key=lambda kv: kv[1])
    moved = {k: got["params"][k] - got["start"][k] for k in keep}
    last = leaf_gaps(moved, change, keep)
    assert np.median(list(last.values())) < CHANGE_MEDIAN_RTOL
    assert max(last.values()) < CHANGE_RTOL, max(last.items(),
                                                 key=lambda kv: kv[1])
    for r in ranks:
        # frozen: the running statistics are as they started, bit for bit
        assert r["stats"].keys() == r["stats0"].keys() and r["stats"]
        assert all(np.array_equal(r["stats"][k], r["stats0"][k])
                   for k in r["stats0"])
        # one exchange of every gradient a step, in float32
        assert len(r["spans"]) == STEPS
        assert all(s["bytes"] == 4 * r["grad_elements"] and s["buckets"] >= 1
                   for s in r["spans"])
    # both ranks hold the same parameters after the three steps
    assert ranks[1]["params"].keys() == got["params"].keys()
    assert all(np.array_equal(ranks[1]["params"][k], got["params"][k])
               for k in got["params"])


def test_the_block_sum_is_the_whole_batch():
    params, stats = weights()
    images, labels = make_batches()[0]
    whole = FrozenTrainer(params, stats, recipe(), blocks=1)
    blocks = FrozenTrainer(params, stats, recipe(), blocks=4)
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    with ref_model.exact_float32():
        loss1, g1, u1 = whole.loss_and_grads(x, y)
        loss4, g4, u4 = blocks.loss_and_grads(x, y)
    assert u1 == u4 == {}
    assert float(loss4) == pytest.approx(float(loss1), rel=1e-6)
    for p in g1:
        d = torch.linalg.vector_norm((g4[p] - g1[p]).double())
        n = torch.linalg.vector_norm(g1[p].double())
        assert d <= 1e-5 * n + 1e-12, p
