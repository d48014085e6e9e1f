"""The readers of the port's spans (``utils/profiling.py``): a traced run
of each cell, shrunk, on the CPU reports each of its span metrics as a
finite positive number; with no trace, or with a port that keeps no
spans, each reader returns nothing."""

import argparse
import math
import pathlib
import tempfile

import pytest

from bench_h100 import common
from bench_h100 import run as bench_run

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
SHRINK = {"backbone": "resnet_v1_50", "image_size": 64, "resize_min": 72,
          "resize_max": 144}
SPAN_METRICS = {
    "mpii224_http_poisson": ["queue_wait_ms.serve", "decode_wait_ms.serve",
                             "decode_ms.serve"],
    "mpii224_train_records": ["input_wait_ms.train", "decode_ms.train",
                              "forward_ms.train", "backward_ms.train",
                              "optimizer_ms.train"],
}


def traced_small_run(workload: str, seed: int = 2 ** 31 + 33) -> dict:
    with tempfile.TemporaryDirectory() as d:
        ctx = bench_run.make_context(argparse.Namespace(
            workload=workload, seed=seed, seconds=2.0, trace=1), tmpdir=d,
            device="cpu", shrink=SHRINK)
        tr = ctx.traffic
        if tr["driver"] == "serve_http":
            tr.update(rate_per_s=12, warm_seconds=0.5, pool_images=6,
                      connections=4)
            tr["check"]["sample"] = 8
            tr["server"]["buckets"] = [1, 8]
            tr["trace"] = {"offset_s": 0.2, "seconds": 1.5}
        else:
            tr.update(records=16, pool_images=4, warm_steps=4)
            tr["trace"] = {"skip_steps": 0, "steps": 2}
            ctx.shrink["batch_size"] = 4
        out = common.driver_module(tr["driver"]).run(ctx)
        return bench_run.result_line(ctx, out, common.load_benchmark(ROOT))


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_a_traced_run_reports_its_span_metrics(workload):
    line = traced_small_run(workload)
    assert line["correct"], line["checks"]
    listed = [m["name"] for m in common.metrics_for(
        common.load_benchmark(ROOT), workload, "per_layer")]
    for name in SPAN_METRICS[workload]:
        assert name in listed
        v = line["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
        assert line["metrics"][name]["unit"] == "ms"


@pytest.mark.parametrize("name", sorted(
    n for names in SPAN_METRICS.values() for n in names))
def test_a_port_without_spans_reads_nothing(name, monkeypatch):
    from attentionalpoolingaction_torch.utils import profiling
    read = common.load_reader(ROOT, name)
    assert read({}) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert read({"trace": object()}) is None
