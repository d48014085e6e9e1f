"""The train step as a CUDA graph (``train.StepGraphs``), on one card and
a rank of a data-parallel NCCL mesh.

On the CPU: the rule that decides between the graph and the eager step,
one case a reason; the one exchange the eager mesh step and the graph's
body share; the ranks' vote on a capture, over two gloo ranks.  On a
card (marked ``cuda``; they skip without one):
the graphed step against the eager step of the same state over 6 steps
of a schedule whose learning rate moves every step, with attention and
with pose attention (losses, ``grad_norm``, parameters, batch norm's
buffers, momentum, the EMA, within 1e-6 relative), the capture leaving
the state as it was, a step's metrics surviving the next step, a restore
between steps or a change of TF32 capturing again, and the head's kernels
run at each replay, counted from the profiler's trace.  The card's tests run with cuDNN's
deterministic algorithms, so that two eager runs agree bit for bit and a
gap is the graph's.  On two cards, two NCCL ranks graph the mesh step.

Run the card's tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_train_graph.py`` (no JAX on the card's machine).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import precision, train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel.zero1 import Zero1Optimizer

from kernel_trace import traced

torch.set_num_threads(2)
REL = 1e-6
STEPS = 6


def small_cfg(**kw):
    kw = {"pooling": "attention", **kw}
    return config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", image_size=64,
        batch_size=4, bf16_backbone=False, **kw)


def batches(n: int, device, cfg=None, seed: int = 5):
    """``n`` seeded batches of ``cfg``'s shape (default
    :func:`small_cfg`): images and labels, and with pose attention the
    crop transforms, keypoints and visibilities."""
    cfg = cfg or small_cfg()
    spec = train.get_dataset(cfg.dataset)
    rng = np.random.default_rng(seed)
    return [train.batch_to_device(precision.synthetic_batch(rng, cfg, spec),
                                  device) for _ in range(n)]


# -- the rule, on the CPU -----------------------------------------------------

@pytest.fixture(scope="module")
def cpu_state():
    state, _ = train.create_state(small_cfg(), device="cpu")
    return state


def _adamw(model, capturable: bool):
    mask = train.decay_mask(model)
    named = list(model.named_parameters())
    return torch.optim.AdamW(
        [{"params": [p for n, p in named if mask[n]], "weight_decay": 1e-4},
         {"params": [p for n, p in named if not mask[n]],
          "weight_decay": 0.0}], lr=1e-3, capturable=capturable)


def _zero1(model, cfg):
    """ZeRO-1's optimizer over a data axis of one (every slice whole)."""
    names = train.optimizer_param_names(model)
    params = dict(model.named_parameters())
    return Zero1Optimizer(
        lambda ts: train.make_optimizer(cfg, model, dict(zip(names, ts))),
        names, [params[n] for n in names], [mesh_lib.REPLICATED] * len(names),
        None, 0, 1)


@pytest.fixture
def joined(tmp_path):
    """A gloo process group of one, left again after the test."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        yield
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def as_nccl(monkeypatch):
    """The process group reads as NCCL's, which the CPU cannot start."""
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda group=None: "nccl")


# cases of a process group: (over NCCL, with a data mesh)
JOINED = {"process_group": (False, False), "gloo_mesh": (False, True),
          "nccl_group": (True, False), "nccl_mesh": (True, True),
          "model_axis": (True, True), "zero1": (True, True)}


@pytest.mark.parametrize("case, want", [
    ("cpu", []), ("mesh", ["mesh"]), ("process_group", ["mesh"]),
    ("grad_accum_steps", ["grad_accum_steps"]),
    ("remat_units", ["remat_units"]), ("adamw", ["optimizer"]),
    ("nesterov", ["optimizer"]), ("adamw_capturable", ["optimizer"]),
    ("shapes", ["shapes"]), ("gloo_mesh", ["mesh"]), ("nccl_group", []),
    ("nccl_mesh", []), ("model_axis", ["model_axis"]),
    ("zero1", ["optimizer"])])
def test_the_step_graphs_only_where_nothing_stands_in_its_way(
        case, want, cpu_state, request, monkeypatch):
    """A CPU state always gives ``device``; each case adds its own reason
    and no other (every AdamW steps eagerly, ``capturable`` or not).  A
    process group names ``mesh`` unless its collectives are NCCL's: a
    data-parallel mesh over NCCL graphs; a model axis and ZeRO-1 do not.
    Leaving the group takes its reason away."""
    state, cfg, mesh = cpu_state, small_cfg(), None
    if case == "mesh":
        mesh = object()
    elif case == "grad_accum_steps":
        cfg = dataclasses.replace(cfg, grad_accum_steps=2)
    elif case == "remat_units":
        cfg = dataclasses.replace(cfg, remat_units=True)
    elif case in ("adamw", "adamw_capturable"):
        state = dataclasses.replace(state, optimizer=_adamw(
            state.model, capturable=case == "adamw_capturable"))
    elif case == "nesterov":
        state = dataclasses.replace(state, optimizer=torch.optim.SGD(
            state.model.parameters(), lr=1e-3, momentum=0.9, nesterov=True))
    if case in JOINED:
        nccl, on_mesh = JOINED[case]
        request.getfixturevalue("joined")
        if nccl:
            as_nccl(monkeypatch)
        if on_mesh:
            mesh = mesh_lib.make_mesh((1,), ("data",))
            state = dataclasses.replace(state, mesh=mesh)
        if case == "zero1":
            state.optimizer = _zero1(state.model, cfg)
        elif case == "model_axis":
            state.plan = mesh_lib.ShardingPlan({}, {}, {}, model_size=2)
    graphs = train.StepGraphs(cfg, None, None, mesh)
    if case == "shapes":
        graphs.graphs = {("another key", i): None
                         for i in range(train.MAX_STEP_GRAPHS)}
    batch = batches(1, "cpu")[0]
    assert graphs.eager_reasons(state, batch) == ["device"] + want
    if case == "process_group":
        torch.distributed.destroy_process_group()
        assert graphs.eager_reasons(state, batch) == ["device"]


def test_a_cpu_step_runs_eagerly(cpu_state):
    step = train.make_train_step(train.get_dataset("mpii"), small_cfg())
    state, metrics = step(cpu_state, batches(1, "cpu")[0])
    assert state.step == 1 and np.isfinite(float(metrics["loss/total"]))
    assert (step.graphs.captures, step.graphs.replays) == (0, 0)
    assert step.graphs.graphs == {}


def todays_exchange(state, metrics, group):
    """The eager mesh step's exchange as it was written inline before the
    graph shared it: the reference of the shared one."""
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh_lib.all_reduce_flat([p.grad for p in state.model.parameters()],
                             group)
    keys = sorted(metrics)
    shares = torch.stack([metrics[k] for k in keys])
    torch.distributed.all_reduce(shares, group=group)
    return dict(zip(keys, shares.unbind()))


def graph_body_on_cpu(state, cfg, spec, group, batch):
    """``_StepGraph._body`` run eagerly on the CPU, outside a capture, from
    the static inputs a capture would hold."""
    graph = object.__new__(train._StepGraph)
    graph.model, graph.opt, graph.ema = (state.model, state.optimizer,
                                         state.ema_params)
    graph.cfg, graph.group, graph.inputs = cfg, group, batch
    graph.loss_fn = train.make_loss_fn(spec, cfg, group)
    graph.lr = torch.tensor(train.make_learning_rate(cfg)(state.step))
    graph.decay = torch.zeros(())
    for p in state.model.parameters():
        state.optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
    return graph._body(state)


def test_the_eager_step_and_the_graph_body_make_one_exchange(
        joined, monkeypatch):
    """On a gloo group of one: the eager mesh step and the graph's body
    each call ``train._exchange`` once, and their metrics and clipped
    gradients are bit for bit those of the exchange written out in
    :func:`todays_exchange`."""
    cfg, spec = small_cfg(), train.get_dataset("mpii")
    mesh = mesh_lib.make_mesh((1,), ("data",))
    group = mesh_lib.axis_group(mesh, "data")
    batch = batches(1, "cpu")[0]
    calls = []
    shared = train._exchange

    def spy(model, metrics, grp):
        calls.append(grp)
        return shared(model, metrics, grp)

    def fresh():
        return train.create_state(cfg, device="cpu", mesh=mesh)[0]

    want = fresh()
    loss_fn = train.make_loss_fn(spec, cfg, group)
    total, metrics = loss_fn(want.model, batch, True)
    total.backward()
    metrics = todays_exchange(want, metrics, group)
    metrics["grad_norm"] = train._clip_gradients(want, cfg)
    monkeypatch.setattr(train, "_exchange", spy)
    eager = fresh()
    _, got = train.make_train_step(spec, cfg, mesh)(eager, batch)
    body = fresh()
    from_body = graph_body_on_cpu(body, cfg, spec, group, batch)
    assert calls == [group, group]
    for state, out in ((eager, got), (body, from_body)):
        assert out.keys() == metrics.keys()
        for k, v in metrics.items():
            assert torch.equal(out[k], v), k
        for p, q in zip(state.model.parameters(), want.model.parameters()):
            assert torch.equal(p.grad, q.grad)


VOTE_WORKER = r"""
import json
import sys
import types

import numpy as np
import torch

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
torch.set_num_threads(2)

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import precision, train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost

multihost.setup(f"127.0.0.1:{port}", n, rank, device="cpu")
mesh = mesh_lib.make_mesh((n,), ("data",))
group = mesh_lib.axis_group(mesh, "data")
cfg = config_lib.TrainConfig(dataset="mpii", batch_size=4 * n)
spec = train.get_dataset("mpii")
loss_fn = train.make_loss_fn(spec, cfg, group)
graphs = train.StepGraphs(cfg, loss_fn, None, mesh, group)
batch = {k: torch.from_numpy(v[rank * 4:(rank + 1) * 4]) for k, v in
         precision.synthetic_batch(np.random.default_rng(1), cfg,
                                   spec).items()}
short = {k: v[:2] for k, v in batch.items()}


class Fresh:
    def stale(self, state):
        return False


def vote(b):
    agreed, counts = graphs.agree(types.SimpleNamespace(step=0), b)
    return [agreed, None if counts is None else counts.tolist()]


out = {"same": vote(batch),
       "differ": vote(short if rank == n - 1 else batch)}
# rank 0 holds a fresh graph of its key and replays it, whose first
# collective is the counts' all-reduce with an empty ballot; the last
# rank's key is new
if rank == 0:
    graphs.graphs[train._graph_key(batch)] = Fresh()
    out["replaying"] = vote(batch)
    loss_fn.counts(batch)
else:
    out["replaying"] = vote(short)
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(out, f)
print(f"WORKER{rank} OK")
"""


def test_the_ranks_capture_only_when_every_rank_votes_for_one_key(
        tmp_path):
    """Two gloo ranks vote (``StepGraphs.agree``) in the counts'
    all-reduce: with one key they capture; with keys that differ each
    steps eagerly with the global counts the vote summed (4 + 2 rows); a
    rank whose graph is fresh replays without a vote, and the other's
    vote, which meets the replay's counts, fails."""
    import json

    from torch_spawn import finish, start_workers

    finish(start_workers(VOTE_WORKER, tmp_path, n=2), timeout=240)
    out = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert [o["same"] for o in out] == [[True, None]] * 2
    for o in out:
        agreed, counts = o["differ"]
        assert not agreed and counts[0] == 6.0 and counts[1] == 2.0
    assert out[0]["replaying"] == [True, None]
    agreed, counts = out[1]["replaying"]
    assert not agreed and counts[:2] == [6.0, 1.0]


# -- on a card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step's graph and the head's "
                    "kernels have no CPU mode")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield "cuda"
    finally:
        torch.backends.cudnn.deterministic = was


def card_cfg(**kw):
    # the learning rate moves every step: 3 warmup steps, then cosine
    return small_cfg(learning_rate=0.05, lr_schedule="cosine",
                     warmup_steps=3, num_steps=9, ema_decay=0.999, **kw)


def readings(state) -> dict[str, torch.Tensor]:
    """Every tensor a step moves: parameters, buffers, optimizer state,
    EMA."""
    out = {f"param.{n}": p for n, p in state.model.named_parameters()}
    out.update({f"buffer.{n}": b for n, b in state.model.named_buffers()})
    for n, p in state.model.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"opt.{n}.{k}"] = v
    out.update({f"ema.{n}": t for n, t in (state.ema_params or {}).items()})
    return {k: v.detach().clone() for k, v in out.items()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def assert_agree(got: dict, want: dict, tol: float = REL) -> None:
    assert got.keys() == want.keys()
    worst = max(((rel(got[k], want[k]), k) for k in want), default=(0, ""))
    assert worst[0] <= tol, worst


def run(cfg, batch_list, *, graphed: bool, reload_before=None):
    """Fresh seeded state, ``len(batch_list)`` steps; ``reload_before``:
    the step index before which the state is saved and loaded back
    (``load_payload``).  Returns the state, each step's metrics and the
    step function."""
    state, spec = train.create_state(cfg, device="cuda")
    step = train.make_train_step(spec, cfg)
    fn = step if graphed else step.eager
    out = []
    for k, b in enumerate(batch_list):
        if k == reload_before:
            buf = io.BytesIO()
            torch.save(state.payload(), buf)
            buf.seek(0)
            state.load_payload(torch.load(buf, map_location="cuda"))
        state, m = fn(state, b)
        out.append(m)
    torch.cuda.synchronize()
    return state, out, step


def metrics_of(steps: list[dict]) -> dict[str, torch.Tensor]:
    return {f"{k}@{i}": v for i, m in enumerate(steps) for k, v in m.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("pooling", ["attention", "pose_attention"])
def test_graphed_steps_match_the_eager_steps(card, pooling):
    """Pose attention also draws its heatmap targets inside the graph
    (the crop and flip of the keypoints)."""
    cfg = card_cfg(pooling=pooling)
    data = batches(STEPS, card, cfg)
    eager, e_metrics, _ = run(cfg, data, graphed=False)
    graphed, g_metrics, step = run(cfg, data, graphed=True)
    assert (step.graphs.captures, step.graphs.replays) == (1, STEPS)
    assert graphed.step == eager.step == STEPS
    assert_agree(metrics_of(g_metrics), metrics_of(e_metrics))
    assert_agree(readings(graphed), readings(eager))
    assert [g["lr"] for g in graphed.optimizer.param_groups] == [
        g["lr"] for g in eager.optimizer.param_groups]
    # the parameters, the momentum and the EMA all moved
    assert rel(readings(graphed)["param.head.attn_w"],
               readings(train.create_state(cfg, device="cpu")[0])[
                   "param.head.attn_w"].cuda()) > 1e-4


@pytest.mark.cuda
def test_the_capture_leaves_the_state_as_it_was(card):
    cfg = card_cfg()
    state, spec = train.create_state(cfg, device="cuda")
    step = train.make_train_step(spec, cfg)
    before = readings(state)
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    step.graphs.capture(state, batches(1, card)[0])
    after = readings(state)
    # the momentum a first step starts from is made: zeros
    made = {k for k in after if k not in before}
    assert made and all(k.endswith(".momentum_buffer") for k in made)
    assert all(not after[k].any() for k in made)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert state.step == 0
    assert [g["lr"] for g in state.optimizer.param_groups] == lrs


@pytest.mark.cuda
def test_a_steps_metrics_outlive_the_next_step(card):
    cfg = card_cfg()
    data = batches(3, card)
    state, spec = train.create_state(cfg, device="cuda")
    step = train.make_train_step(spec, cfg)
    _, first = step(state, data[0])
    kept = {k: v.clone() for k, v in first.items()}
    _, second = step(state, data[1])
    _, third = step(state, data[2])
    torch.cuda.synchronize()
    for k, v in kept.items():
        assert torch.equal(first[k], v), k
        assert first[k].data_ptr() != second[k].data_ptr()
        assert second[k].data_ptr() != third[k].data_ptr()
    assert not torch.equal(first["loss/total"], second["loss/total"])


@pytest.mark.cuda
def test_a_restore_between_steps_captures_again(card):
    cfg = card_cfg()
    data = batches(STEPS, card)
    eager, e_metrics, _ = run(cfg, data, graphed=False, reload_before=3)
    graphed, g_metrics, step = run(cfg, data, graphed=True, reload_before=3)
    assert (step.graphs.captures, step.graphs.replays) == (2, STEPS)
    assert_agree(metrics_of(g_metrics), metrics_of(e_metrics))
    assert_agree(readings(graphed), readings(eager))


@pytest.mark.cuda
def test_a_change_of_tf32_captures_again(card):
    """A capture keeps the TF32 setting it was made under; the eager step
    reads it at each call, so a change of it is a new graph."""
    cfg = card_cfg()
    data = batches(4, card)
    was = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for graphed in (False, True):
            torch.backends.cudnn.allow_tf32 = True
            state, spec = train.create_state(cfg, device="cuda")
            step = train.make_train_step(spec, cfg)
            fn = step if graphed else step.eager
            ms = []
            for k, b in enumerate(data):
                torch.backends.cudnn.allow_tf32 = k < 2
                ms.append(fn(state, b)[1])
            out[graphed] = (ms, readings(state))
    finally:
        torch.backends.cudnn.allow_tf32 = was
    assert (step.graphs.captures, step.graphs.replays) == (2, 4)
    assert_agree(metrics_of(out[True][0]), metrics_of(out[False][0]))
    assert_agree(out[True][1], out[False][1])


@pytest.mark.cuda
def test_each_replay_runs_the_head_kernels(card):
    """Each step's trace: the first rehearses the step eagerly
    ``train._REHEARSALS`` times, captures it (which runs nothing) and
    replays it; each later step is one replay.  Each rehearsal and each
    replay runs each head kernel once."""
    cfg = card_cfg()
    data = batches(3, card)
    state, spec = train.create_state(cfg, device="cuda")
    step = train.make_train_step(spec, cfg)
    for k, b in enumerate(data):
        _, trace = traced(lambda: step(state, b))
        runs = 1 + (train._REHEARSALS if k == 0 else 0)
        assert trace.launches == {"saliency_summary": runs,
                                  "project_logits": runs,
                                  "pool_backward": runs, "ycc_to_rgb": 0}
        assert len(trace.spans("train.capture")) == (k == 0)
        assert len(trace.spans("train.replay")) == 1
    assert (step.graphs.captures, step.graphs.replays) == (1, 3)


# -- two ranks over NCCL --------------------------------------------------------

MESH_WORKER = r"""
import json
import os
import sys

rank, port, tmp, n = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    int(sys.argv[4])
os.environ["LOCAL_RANK"] = str(rank)

import numpy as np
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import precision, train
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
from attentionalpoolingaction_torch.parallel import multihost

dev = multihost.setup(f"127.0.0.1:{port}", n, rank)
torch.backends.cudnn.deterministic = True
mesh = mesh_lib.make_mesh((n,), ("data",))
spec = train.get_dataset("mpii")
ROWS = 4


def readings(state):
    out = {f"param.{k}": p for k, p in state.model.named_parameters()}
    out.update({f"buffer.{k}": b for k, b in state.model.named_buffers()})
    for k, p in state.model.named_parameters():
        for b, v in state.optimizer.state[p].items():
            out[f"opt.{k}.{b}"] = v
    out.update({f"ema.{k}": t for k, t in state.ema_params.items()})
    return {k: v.detach().clone() for k, v in out.items()}


def worst(got, want):
    assert got.keys() == want.keys()
    return max((float((got[k].double() - want[k].double()).norm()
                      / want[k].double().norm().clamp_min(1e-30)), k)
               for k in want)


def same_as_rank0(state):
    flat = torch.cat([t.detach().reshape(-1).double()
                      for t in state.model.state_dict().values()
                      if t.is_floating_point()])
    theirs = flat.clone()
    torch.distributed.broadcast(theirs, src=0)
    return bool(torch.equal(flat, theirs))


def run(cfg, variables, data, graphed):
    state, _ = train.create_state(cfg, device=dev, variables=variables,
                                  mesh=mesh)
    step = train.make_train_step(spec, cfg, mesh)
    fn = step if graphed else step.eager
    metrics, after = [], []
    for b in data:
        state, m = fn(state, train.batch_to_device(b, dev))
        metrics.append({k: v.clone() for k, v in m.items()})
        after.append((readings(state), (step.graphs.captures,
                                        step.graphs.replays)))
    torch.cuda.synchronize()
    return metrics, after, same_as_rank0(state)


report = {}
for freeze in (True, False):
    cfg = config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", image_size=64,
        batch_size=ROWS * n, bf16_backbone=False, pooling="attention",
        freeze_bn=freeze, learning_rate=0.05, lr_schedule="cosine",
        warmup_steps=3, num_steps=9, ema_decay=0.999, mesh_shape=(n,))
    variables = precision.seeded_variables(cfg, 3)
    rng = np.random.default_rng(5)
    data = [{k: v[rank * ROWS:(rank + 1) * ROWS] for k, v in
             precision.synthetic_batch(rng, cfg, spec).items()}
            for _ in range(4)]
    # the fourth step: the last rank takes half its rows, a key it has no
    # graph of, where the others replay theirs
    short = dict(data[3])
    if rank == n - 1:
        short = {k: v[:ROWS // 2] for k, v in short.items()}
    graphed = run(cfg, variables, data[:3] + [short], True)
    eager = run(cfg, variables, data[:3] + [short], False)
    out = {"counts": [a[1] for a in graphed[1]],
           "replica": [graphed[2], eager[2]],
           "metrics": max((abs(float(g[k]) - float(e[k]))
                           / max(abs(float(e[k])), 1e-30), f"{k}@{i}")
                          for i, (g, e) in enumerate(zip(graphed[0],
                                                         eager[0]))
                          for k in e),
           "state": [worst(g[0], e[0]) for g, e in zip(graphed[1],
                                                       eager[1])]}
    # a fresh step whose first batch differs in rows on the last rank: a
    # new key on every rank, and the votes differ
    first = run(cfg, variables, [short, data[1]], True)
    out["first"] = [a[1] for a in first[1]]
    report["frozen" if freeze else "train_bn"] = out
with open(f"{tmp}/rank{rank}.json", "w") as f:
    json.dump(report, f)
torch.distributed.destroy_process_group()
print(f"WORKER{rank} OK")
"""


@pytest.mark.cuda
def test_two_nccl_ranks_graph_the_mesh_step(tmp_path):
    """Two ranks over NCCL, frozen and train-mode batch norm (its
    statistics' all-reduces then in the graph too): four steps graphed
    and four eager from the same seeded state, the last with half the
    rows on rank 1.  The graphed steps agree with the eager ones (the
    losses, ``grad_norm``, and every parameter, buffer, momentum and EMA
    within 1e-6 relative after each step), every rank holds rank 0's bits
    after either run, each rank captures once at step 1 and replays
    steps 1-3, and at step 4 rank 0 replays while rank 1, whose key is
    new, steps eagerly.  A fresh step whose first batches differ by rank
    steps eagerly on every rank, and captures at step 2, where they
    agree."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: one NCCL rank a card")
    import json

    from torch_spawn import finish, start_workers

    finish(start_workers(MESH_WORKER, tmp_path, n=2), timeout=420)
    for rank in range(2):
        report = json.loads((tmp_path / f"rank{rank}.json").read_text())
        for tag, out in report.items():
            where = (rank, tag)
            assert out["counts"] == [[1, 1], [1, 2], [1, 3],
                                     [1, 4 if rank == 0 else 3]], where
            assert out["replica"] == [True, True], where
            assert out["metrics"][0] <= REL, (where, out["metrics"])
            for gap in out["state"]:
                assert gap[0] <= REL, (where, gap)
            assert out["first"] == [[0, 0], [1, 1]], where
