"""The readers of the graphed train step's spans (``train.replay`` and its
child ``train.graph_launch``, ``utils/profiling.py``): the share of the
traced steps that were replays, and a replay's host ms outside the
graph's launch; nothing with no trace, with no replay, or with a port
that keeps no spans.  The CPU runs the eager step, so a shrunk traced run
there reports neither."""

import pathlib

import pytest

from bench_h100 import common
from bench_h100.tests.test_h100bench_spans import traced_small_run

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
WORKLOAD = "mpii224_train_records"
GRAPH_METRICS = ["graphed_share.train", "replay_ms.train"]


def test_the_cpus_eager_step_reports_no_replay():
    line = traced_small_run(WORKLOAD)
    assert line["correct"], line["checks"]
    listed = [m["name"] for m in common.metrics_for(
        common.load_benchmark(ROOT), WORKLOAD, "per_layer")]
    for name in GRAPH_METRICS:
        assert name in listed
        assert name not in line["metrics"], name


@pytest.mark.parametrize("replays, share, replay_ms", [
    (4, 100.0, 2.5), (1, 25.0, 0.625), (0, None, None)])
def test_the_graph_readers_read_replays_over_steps(replays, share, replay_ms,
                                                   monkeypatch):
    """Over 4 traced steps, ``replays`` of them replays of 8 ms each, 5.5
    of it the graph's launch: the share of steps replayed, and the
    replays' ms a step outside the launch; nothing without a replay (the
    eager step, or a port that keeps no such span)."""
    from attentionalpoolingaction_torch.utils import profiling
    tot = {"train.step": {"count": 4, "seconds": 0.2, "self_seconds": 0.0}}
    if replays:
        tot["train.replay"] = {"count": replays, "seconds": 8e-3 * replays,
                               "self_seconds": 2.5e-3 * replays}
        tot["train.graph_launch"] = {"count": replays,
                                     "seconds": 5.5e-3 * replays,
                                     "self_seconds": 5.5e-3 * replays}
    monkeypatch.setattr(profiling, "span_totals", lambda: tot)
    ctx = {"trace": object()}
    for name, want in [("graphed_share.train", share),
                       ("replay_ms.train", replay_ms)]:
        got = common.load_reader(ROOT, name)(ctx)
        if want is None:
            assert got is None, name
        else:
            assert got == pytest.approx(want), name
        assert common.load_reader(ROOT, name)({}) is None
    monkeypatch.delattr(profiling, "span_totals")
    for name in GRAPH_METRICS:
        assert common.load_reader(ROOT, name)(ctx) is None
