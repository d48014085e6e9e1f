"""The single-card train step as a CUDA graph (``train.StepGraphs``).

On the CPU: the rule that decides between the graph and the eager step,
one case a reason.  On a card (marked ``cuda``; they skip without one):
the graphed step against the eager step of the same state over 6 steps
of a schedule whose learning rate moves every step, with attention and
with pose attention (losses, ``grad_norm``, parameters, batch norm's
buffers, momentum, the EMA, within 1e-6 relative), the capture leaving
the state as it was, a step's metrics surviving the next step, a restore
between steps or a change of TF32 capturing again, and the head's kernels
run at each replay, counted from the profiler's trace.  The card's tests run with cuDNN's
deterministic algorithms, so that two eager runs agree bit for bit and a
gap is the graph's.

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


@pytest.mark.parametrize("case, want", [
    ("cpu", []), ("mesh", ["mesh"]), ("process_group", ["mesh"]),
    ("grad_accum_steps", ["grad_accum_steps"]),
    ("remat_units", ["remat_units"]), ("adamw", ["optimizer"]),
    ("nesterov", ["optimizer"]), ("adamw_capturable", ["optimizer"]),
    ("shapes", ["shapes"])])
def test_the_step_graphs_only_where_nothing_stands_in_its_way(
        case, want, cpu_state, tmp_path):
    """A CPU state always gives ``device``; each case adds its own reason
    and no other (every AdamW steps eagerly, ``capturable`` or not)."""
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
    graphs = train.StepGraphs(cfg, None, None, mesh)
    batch = batches(1, "cpu")[0]
    if case == "shapes":
        graphs.graphs = {("another key", i): None
                         for i in range(train.MAX_STEP_GRAPHS)}
    if case != "process_group":
        assert graphs.eager_reasons(state, batch) == ["device"] + want
        return
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        assert graphs.eager_reasons(state, batch) == ["device"] + want
    finally:
        torch.distributed.destroy_process_group()
    assert graphs.eager_reasons(state, batch) == ["device"]


def test_a_cpu_step_runs_eagerly(cpu_state):
    step = train.make_train_step(train.get_dataset("mpii"), small_cfg())
    state, metrics = step(cpu_state, batches(1, "cpu")[0])
    assert state.step == 1 and np.isfinite(float(metrics["loss/total"]))
    assert (step.graphs.captures, step.graphs.replays) == (0, 0)
    assert step.graphs.graphs == {}


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
