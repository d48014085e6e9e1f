"""The readers of the graphed data-parallel step's spans, on rank 0's span
totals as the ``train_mesh`` worker hands them over (``span_totals``):
``graphed_share.mesh``, the share of the traced steps that were replays,
and ``replay_ms.mesh``, a replay's host ms outside the graph's launch;
nothing with no trace, no totals, or no replay (the eager mesh step)."""

import pathlib

import pytest

from bench_h100 import common, trace

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
CELL = "mpii450_mesh4_train"
METRICS = ["graphed_share.mesh", "replay_ms.mesh"]


def read(name, ctx):
    return common.load_reader(ROOT, name)(ctx)


def summary():
    return trace.Summary(window_s=1.0, busy_s=0.5, kernels={},
                         idle_by_host={})


def test_the_cell_lists_both_metrics_under_the_graphed_steps_layer():
    bench = common.load_benchmark(ROOT)
    every = {m["name"]: m for m in bench["per_layer"]}
    listed = {m["name"] for m in common.metrics_for(bench, CELL,
                                                    "per_layer")}
    for name in METRICS:
        assert name in listed and every[name]["workloads"] == [CELL]
        assert every[name]["layer"] == every[
            name.replace(".mesh", ".train")]["layer"]
        assert every[name]["moves"] == "train_images_per_s"


@pytest.mark.parametrize("replays, share, replay_ms", [
    (12, 100.0, 1.5), (3, 25.0, 0.375), (0, None, None)])
def test_the_readers_read_replays_over_steps(replays, share, replay_ms):
    """Over 12 traced steps, ``replays`` of them replays of 7 ms each, 5.5
    of it the graph's launch."""
    tot = {"train.step": {"count": 12, "seconds": 0.6, "self_seconds": 0.0}}
    if replays:
        tot["train.replay"] = {"count": replays, "seconds": 7e-3 * replays,
                               "self_seconds": 1.5e-3 * replays}
        tot["train.graph_launch"] = {"count": replays,
                                     "seconds": 5.5e-3 * replays,
                                     "self_seconds": 5.5e-3 * replays}
    ctx = {"trace": summary(), "span_totals": tot}
    for name, want in zip(METRICS, (share, replay_ms)):
        got = read(name, ctx)
        if want is None:
            assert got is None, name
        else:
            assert got == pytest.approx(want), name


@pytest.mark.parametrize("ctx", [
    {}, {"span_totals": {"train.step": {"count": 12, "seconds": 0.6},
                         "train.replay": {"count": 12, "seconds": 0.1,
                                          "self_seconds": 0.02}}},
    {"trace": "traced", "span_totals": None},
    {"trace": "traced", "span_totals": {}}])
def test_nothing_is_read_without_a_trace_or_its_totals(ctx):
    """An untraced run (no ``trace``, whatever the totals) and a traced
    one whose port kept no spans read nothing."""
    for name in METRICS:
        assert read(name, ctx) is None, name
