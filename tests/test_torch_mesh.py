"""The port's mesh train step (``parallel/``, ``train.make_train_step(...,
mesh)``) in a real job of two processes over gloo on the CPU, against the
port's one-process step and against the JAX package's ``make_train_step``
on a mesh of two of the 8 virtual CPU devices (``tests/conftest.py``), as
``tests/test_sharding.py`` and ``tests/test_zero1.py`` hold the JAX mesh.

One spawn of two workers (``torch_spawn.py``) runs every step of the port
from the same Flax variables (carried across by the weight bridge) on the
same numpy batches, and writes the updated parameters to ``tmp_path``:

* ``mpii``: resnet_v1_50 at 64 px, rank-2 attention, batch 8 (4 a rank),
  batch norm in train mode (reduced over the data axis), clip 10;
* ``pose``: the same with pose attention, two microbatches a step and an
  EMA (the pose loss's visibility count is global; a microbatch is a
  global microbatch split over the data axis, so one process's batch is
  ordered to hold every rank's microbatch i in its microbatch i);
* ``zero1``: ``mpii`` with the momentum sliced over the data axis;
* ``hico``: 600 classes on a ``(1, 2)`` data x model mesh, the head's
  classes sharded 300 a rank (tensor parallelism);
* ``masked``: ``hico`` data-parallel on a batch whose ``mask`` keeps 3
  rows on one rank and 1 on the other (the loss divides by the global
  mask sum).

Bounds, the JAX tests' own: data parallelism vs one process, the loss to
1e-4 relative and every parameter to 1e-4 absolute (``test_sharding.py``);
ZeRO-1 vs data parallelism 1e-5 (``test_zero1.py``); tensor parallelism
vs one process 1e-4.  Against JAX's mesh steps, the bounds of
``tests/test_torch_train_step.py`` for a first step from a shared state:
the loss to 1e-4 relative, each parameter's change to 0.5 relative in L2
per leaf and 0.1 over all leaves (two correct float32 train steps of a
train-mode batch-norm ResNet differ by a few percent in their
gradients; see that file's docstring).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from attentionalpoolingaction_tpu import config as jax_config
from attentionalpoolingaction_tpu import train as jax_train
from attentionalpoolingaction_tpu.parallel import mesh as jax_mesh
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from torch_spawn import finish, start_workers

torch.set_num_threads(2)

BASE = dict(dataset="mpii", backbone="resnet_v1_50", pooling="attention",
            rank=2, image_size=64, batch_size=8, bf16_backbone=False,
            learning_rate=1e-3, grad_clip_norm=10.0, lr_schedule="constant")
CASES = {
    "mpii": dict(mesh_shape=(2,)),
    "pose": dict(pooling="pose_attention", grad_accum_steps=2,
                 ema_decay=0.999, mesh_shape=(2,)),
    "zero1": dict(mesh_shape=(2,), zero1=True),
    "hico": dict(dataset="hico", mesh_shape=(1, 2),
                 mesh_axes=("data", "model")),
    "masked": dict(dataset="hico", mesh_shape=(2,)),
}
# the variables and batch each case starts from
SOURCE = {"mpii": "mpii", "pose": "pose", "zero1": "mpii", "hico": "hico",
          "masked": "masked"}

WORKER = r"""
import json
import sys

import numpy as np
import torch

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
torch.set_num_threads(2)

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost
from attentionalpoolingaction_torch.parallel.zero1 import Zero1Optimizer

multihost.setup(f"127.0.0.1:{port}", n, rank, device="cpu")
cases = json.loads(open(tmp + "/cases.json").read())
report = {}


def load(name):
    z = np.load(f"{tmp}/{name}.npz")
    params = {k[2:]: z[k] for k in z.files if k.startswith("p/")}
    stats = {k[2:]: z[k] for k in z.files if k.startswith("s/")}
    batch = {k[2:]: z[k] for k in z.files if k.startswith("b/")}
    return params, stats, batch


def variables(params, stats):
    # the port's state dict back to Flax trees for create_state
    sd = {k: torch.from_numpy(v) for k, v in {**params, **stats}.items()}
    return convert.state_dict_to_flax(sd)


def step(cfg, src, mesh):
    params, stats, batch = load(src)
    accum = cfg.grad_accum_steps
    if mesh is None and accum > 1:
        # one process's microbatch i is every rank's microbatch i (a
        # global microbatch split over the data axis): reorder the rows
        batch = {k: v.reshape((n, accum, -1) + v.shape[1:]).swapaxes(0, 1)
                 .reshape(v.shape) for k, v in batch.items()}
    state, spec = train.create_state(cfg, device="cpu",
                                     variables=variables(params, stats),
                                     mesh=mesh)
    fn = train.make_train_step(spec, cfg, mesh)
    rows = (mesh_lib.shard_batch(batch, mesh) if mesh is not None else
            {k: torch.from_numpy(v) for k, v in batch.items()})
    state, metrics = fn(state, rows)
    return state, {k: float(v) for k, v in metrics.items()}


def dump(state):
    return {k: v.numpy() for k, v in state.full_state_dict().items()
            if not k.endswith("num_batches_tracked")}


for name, (kw, src) in cases.items():
    cfg = config_lib.TrainConfig(**kw)
    mesh = mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    state, metrics = step(cfg, src, mesh)
    out = dump(state)
    # every rank holds the same parameters after the step
    flat = torch.cat([torch.from_numpy(v).reshape(-1)
                      for _, v in sorted(out.items())])
    parts = [torch.empty_like(flat) for _ in range(n)]
    torch.distributed.all_gather(parts, flat)
    rec = {"metrics": metrics,
           "rank_gap": max(float((p - flat).abs().max()) for p in parts)}
    if name == "zero1":
        opt = state.optimizer
        assert isinstance(opt, Zero1Optimizer)
        conv1 = state.model.resnet.conv1.weight
        buf = opt.inner.state[opt.tensors[opt.names.index(
            "resnet.conv1.weight")]]["momentum_buffer"]
        rec["conv1_momentum"] = list(buf.shape)
        rec["conv1_weight"] = list(conv1.shape)
        rec["sliced"] = len(opt.sliced)
    if name == "hico":
        rec["attn_w"] = list(state.model.head.attn_w.shape)
    if name == "masked":
        rec["local_mask"] = float(load(src)[2]["mask"].reshape(
            n, -1)[rank].sum())
    report[name] = rec
    if rank == 0:
        np.savez(f"{tmp}/{name}_mesh.npz", **out)
        # the same step in one process, on the whole batch
        one_cfg = config_lib.TrainConfig(**{**kw, "mesh_shape": (1,),
                                             "mesh_axes": ("data",),
                                             "zero1": False})
        one, one_metrics = step(one_cfg, src, None)
        np.savez(f"{tmp}/{name}_one.npz", **dump(one))
        report[name]["one_metrics"] = one_metrics
if rank == 0:
    open(tmp + "/report.json", "w").write(json.dumps(report))
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f"WORKER{rank} OK")
"""


def make_batch(rng, cfg, spec):
    b, size = cfg.batch_size, cfg.image_size
    batch = {"image": rng.integers(0, 256, (b, size, size, 3),
                                   dtype=np.uint8)}
    if spec.multi_label:
        batch["label"] = (rng.random((b, spec.num_classes)) > 0.9).astype(
            np.float32)
    else:
        batch["label"] = rng.integers(0, spec.num_classes, b).astype(
            np.int32)
    if cfg.pooling == "pose_attention":
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(0, 8, b), rng.uniform(0, 8, b),
             (np.arange(b) % 2).astype(np.float64)], 1).astype(np.float32)
        batch["keypoints"] = rng.uniform(0, size, (b, 16, 2)).astype(
            np.float32)
        batch["visibility"] = (rng.uniform(size=(b, 16)) > 0.3).astype(
            np.float32)
    return batch


def to_numpy(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def jax_cfg(name, **kw):
    return jax_config.TrainConfig(**{**BASE, **CASES[name], **kw})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    starts = {}
    for src in ("mpii", "pose", "hico"):
        cfg = jax_cfg(src)
        state, spec, model, tx = jax_train.create_state(cfg)
        batch = make_batch(rng, cfg, spec)
        starts[src] = (state, batch)
        sd = convert.flax_to_state_dict(to_numpy(state.params),
                                        to_numpy(state.batch_stats))
        arrays = {f"p/{k}": v.numpy() for k, v in sd.items()
                  if not k.endswith(("running_mean", "running_var"))}
        arrays.update({f"s/{k}": v.numpy() for k, v in sd.items()
                       if k.endswith(("running_mean", "running_var"))})
        arrays.update({f"b/{k}": v for k, v in batch.items()})
        np.savez(tmp / f"{src}.npz", **arrays)
        if src == "hico":
            # 3 rows kept on rank 0's half, 1 on rank 1's
            arrays["b/mask"] = np.array([1, 1, 0, 1, 0, 0, 1, 0],
                                        np.float32)
            np.savez(tmp / "masked.npz", **arrays)
    (tmp / "cases.json").write_text(json.dumps(
        {name: [{**BASE, **kw}, SOURCE[name]] for name, kw in CASES.items()}))
    procs = start_workers(WORKER, tmp)

    # meanwhile, JAX's mesh steps from the same states and batches
    jax_out = {}
    for name in ("mpii", "zero1", "hico"):
        cfg = jax_cfg(name)
        state, batch = starts[SOURCE[name]]
        state = jax.tree.map(jnp.array, state)      # the step donates it
        _, spec, model, tx = jax_train.create_state(cfg)
        mesh = jax_mesh.make_mesh(cfg.mesh_shape, cfg.mesh_axes,
                                  devices=jax.devices()[:2])
        step = jax_train.make_train_step(model, spec, cfg, tx, mesh)
        after, metrics = step(state, jax_mesh.shard_batch(batch, mesh))
        if name == "hico":
            assert after.params["head"]["attn_w"].sharding.spec == P(
                None, "model", None)
        jax_out[name] = (
            convert.flax_to_state_dict(to_numpy(after.params)),
            {k: float(v) for k, v in metrics.items()})
    finish(procs, timeout=400)
    report = json.loads((tmp / "report.json").read_text())

    def load(name, kind):
        z = np.load(tmp / f"{name}_{kind}.npz")
        return {k: torch.from_numpy(z[k]) for k in z.files}

    before = {src: convert.flax_to_state_dict(to_numpy(s.params))
              for src, (s, _) in starts.items()}
    before["masked"] = before["hico"]
    return {"report": report, "load": load, "jax": jax_out,
            "before": before}


def max_abs(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


@pytest.mark.parametrize("name", ["mpii", "pose", "masked"])
def test_data_parallel_matches_one_process(run, name):
    rep = run["report"][name]
    for k, v in rep["one_metrics"].items():
        if k.startswith("loss"):
            assert abs(rep["metrics"][k] - v) <= 1e-4 * abs(v), (k, rep)
    assert max_abs(run["load"](name, "mesh"), run["load"](name, "one")) \
        < 1e-4


def test_masked_batch_differs_by_rank(run):
    # the global mask sum (4) is not either rank's (3, 1): a per-rank
    # normalizer would weigh the ranks' rows differently
    assert run["report"]["masked"]["local_mask"] in (1.0, 3.0)


def test_zero1_matches_data_parallel_and_slices_momentum(run):
    rep = run["report"]["zero1"]
    assert abs(rep["metrics"]["loss/total"]
               - run["report"]["mpii"]["metrics"]["loss/total"]) <= \
        1e-5 * abs(rep["metrics"]["loss/total"])
    assert max_abs(run["load"]("zero1", "mesh"),
                   run["load"]("mpii", "mesh")) < 1e-5
    # conv1's (64, 3, 7, 7) momentum keeps half its output channels a rank
    assert rep["conv1_weight"] == [64, 3, 7, 7]
    assert rep["conv1_momentum"] == [32, 3, 7, 7]
    assert rep["sliced"] > 100


def test_tensor_parallel_matches_one_process(run):
    rep = run["report"]["hico"]
    assert rep["attn_w"] == [2048, 300, 2]
    v = rep["one_metrics"]["loss/total"]
    assert abs(rep["metrics"]["loss/total"] - v) <= 1e-4 * abs(v)
    assert max_abs(run["load"]("hico", "mesh"), run["load"]("hico", "one")) \
        < 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_state(run, name):
    assert run["report"][name]["rank_gap"] == 0.0


@pytest.mark.parametrize("name", ["mpii", "zero1", "hico"])
def test_mesh_step_matches_jax_mesh_step(run, name):
    want, jax_metrics = run["jax"][name]
    got = run["load"](name, "mesh")
    before = run["before"][SOURCE[name]]
    v = jax_metrics["loss/total"]
    assert abs(run["report"][name]["metrics"]["loss/total"] - v) <= \
        1e-4 * abs(v)
    assert abs(run["report"][name]["metrics"]["grad_norm"]
               - jax_metrics["grad_norm"]) <= 1e-2 * jax_metrics["grad_norm"]
    sq_err = sq_ref = 0.0
    for k, w in want.items():
        d_got, d_want = got[k] - before[k], w - before[k]
        rel = float((d_got - d_want).norm() / d_want.norm().clamp_min(1e-30))
        assert rel < 0.5, (k, rel)
        sq_err += float(((d_got - d_want) ** 2).sum())
        sq_ref += float((d_want ** 2).sum())
    assert (sq_err / sq_ref) ** 0.5 < 0.1


def test_sharding_plan_matches_jax_leaf_by_leaf():
    """The plan of ``parallel.mesh.state_shardings`` against JAX's
    ``state_shardings`` on the same state, for DP, ZeRO-1 over 2 and 4,
    and TP of HICO's and MPII's heads (MPII's 393 classes stay
    replicated), every leaf of the parameters and the momentum."""
    class FakeMesh:
        def __init__(self, sizes):
            self.mesh_dim_names = tuple(sizes)
            self._sizes = sizes

        def size(self, i):
            return self._sizes[self.mesh_dim_names[i]]

    for dataset in ("hico", "mpii"):
        state, _, _, _ = jax_train.create_state(
            jax_config.TrainConfig(**{**BASE, "dataset": dataset}))
        model = train.build_model(
            config_lib.TrainConfig(**{**BASE, "dataset": dataset}),
            device="cpu")
        for shape, axes, zero1 in [((2,), ("data",), False),
                                   ((2,), ("data",), True),
                                   ((4,), ("data",), True),
                                   ((4, 2), ("data", "model"), True),
                                   ((2, 4), ("data", "model"), False)]:
            cfg = jax_config.TrainConfig(**{**BASE, "dataset": dataset,
                                            "mesh_shape": shape,
                                            "mesh_axes": axes,
                                            "zero1": zero1})
            want = jax_train._train_state_shardings(
                cfg, jax_mesh.make_mesh(shape, axes), state)
            fake = FakeMesh(dict(zip(axes, shape)))
            plan = mesh_lib.state_shardings(
                fake, model, model_axis=mesh_lib.model_axis_of(fake),
                zero1_axis="data" if zero1 else None)
            paths = {v[1:]: k for k, v in plan.flax.items()}
            trace = [s.trace for s in jax.tree.leaves(
                want.opt_state, is_leaf=lambda s: hasattr(s, "trace"))
                if hasattr(s, "trace")][0]
            for tree, table in ((want.params, plan.params),
                                (trace, plan.opt_state)):
                leaves = jax.tree_util.tree_leaves_with_path(tree)
                assert len(leaves) == len(table)
                for path, sharding in leaves:
                    name = paths[tuple(p.key for p in path)]
                    spec = tuple(sharding.spec) + (None,) * 4
                    lp = table[name]
                    if lp.kind == "replicated":
                        assert all(a is None for a in spec), (name, spec)
                    else:
                        assert spec[lp.flax_dim] == lp.axis, (name, spec, lp)
                        assert sum(a is not None for a in spec) == 1



@pytest.mark.parametrize("buckets", [(1, 8, 32), (3,), (1, 4, 9, 16)])
def test_data_parallel_buckets_round_as_jax(buckets):
    """The data-parallel serving recipe's buckets equal JAX's
    ``_init_data_parallel`` over the test process's 8 CPU devices, with
    the port's replicas on 8 CPU devices; off, or with one device, both
    keep the buckets as given (sorted, unique)."""
    from attentionalpoolingaction_tpu import serving as jax_serving
    from attentionalpoolingaction_torch import serving

    class Jax(jax_serving.BucketedPredictor):
        pass

    class Port(serving.BucketedPredictor):
        device = torch.device("cpu")

    n = len(jax.local_devices())
    assert n == 8
    want, _, _ = Jax()._init_data_parallel(True, buckets)
    port = Port()
    assert port._init_data_parallel(True, buckets, ["cpu"] * n) == want
    assert len(port.replicas) == n
    off, _, _ = Jax()._init_data_parallel(False, buckets)
    assert port._init_data_parallel(False, buckets, ["cpu"] * n) == off
    assert port.replicas == ()
    assert port._init_data_parallel(True, buckets) == off
    assert port.replicas == ()
