"""The harness: seeded generators, lookup by name (a new cell is a new
traffic file and a new entry, nothing edited), the contract's shape of
``BENCHMARK.json``, the per-layer readers, the import check, and a run
with no card, which fails and prints no result."""

import argparse
import hashlib
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from bench_h100 import common, trace
from bench_h100 import run as bench_run
from bench_h100.generators import images as gen_images
from bench_h100.generators import schedule

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
MIX = [{"width": 160, "height": 90, "share": 0.75},
       {"width": 40, "height": 30, "gray": True, "share": 0.25}]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_same_seed_same_images_and_schedule():
    a = gen_images.make_pool(2 ** 31 + 11, MIX, 8, 90)
    b = gen_images.make_pool(2 ** 31 + 11, MIX, 8, 90)
    c = gen_images.make_pool(2 ** 31 + 12, MIX, 8, 90)
    assert [x["data"] for x in a] == [x["data"] for x in b]
    assert [x["data"] for x in a] != [x["data"] for x in c]
    np.testing.assert_array_equal(schedule.poisson(300, 5),
                                  schedule.poisson(300, 5))
    np.testing.assert_array_equal(schedule.picks(7, 50, 8),
                                  schedule.picks(7, 50, 8))
    assert not np.array_equal(schedule.picks(7, 50, 8),
                              schedule.picks(8, 50, 8))
    assert not np.array_equal(schedule.poisson(300, 5, stream=0),
                              schedule.poisson(300, 5, stream=1))


def test_every_seed_gets_the_same_sizes():
    sizes = [sorted((x["width"], x["height"], x["gray"])
                    for x in gen_images.make_pool(s, MIX, 8, 90))
             for s in (1, 2, 3)]
    assert sizes[0] == sizes[1] == sizes[2]
    assert sum(x[2] for x in sizes[0]) == 2


def test_schedule_mean_rate():
    for stream in (0, 1):
        t = schedule.poisson(400.0, 20.0, stream)
        assert len(t) == 8000
        assert np.all(np.diff(t) >= 0) and 0 <= t[0] and t[-1] < 20.0
        gaps = np.diff(t)
        assert abs(gaps.mean() * 400.0 - 1.0) < 0.02
        # exponential gaps: the std is the mean
        assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05


def tree_hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def copy_benchmark(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_h100", dst / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))


def test_a_new_cell_is_found_with_no_file_edited(tmp_path):
    copy_benchmark(tmp_path)
    before = tree_hashes(tmp_path / "bench_h100")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    base = bench["workloads"][0]
    traffic = json.loads(common.traffic_file(tmp_path, base["name"])
                         .read_text())
    traffic["rate_per_s"] = traffic.get("rate_per_s", 1) * 0.5
    new = dict(base, name="mpii224_new_mix", traffic="mpii224_new_mix",
               why="a test cell")
    common.traffic_file(tmp_path, new["name"]).write_text(json.dumps(traffic))
    bench["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = tree_hashes(tmp_path / "bench_h100")
    assert set(after) - set(before) == {"traffic/mpii224_new_mix.json"}
    assert all(after[k] == v for k, v in before.items())
    ctx = bench_run.make_context(argparse.Namespace(
        workload="mpii224_new_mix", seed=1, seconds=1, trace=0),
        root=tmp_path)
    assert ctx.traffic == traffic
    assert common.driver_module(ctx.traffic["driver"]).run
    metrics = common.metrics_for(bench, "mpii224_new_mix", "end_to_end")
    assert [m["name"] for m in metrics] == ["setup_s"]


def test_a_per_layer_metric_with_no_list_goes_where_its_metric_goes():
    bench = json.loads(json.dumps(common.load_benchmark(ROOT)))
    moves = next(m for m in bench["end_to_end"] if "workloads" in m)
    bench["per_layer"].append({
        "name": "later_metric.x", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": moves["name"]})
    for w in bench["workloads"]:
        names = [m["name"] for m in common.metrics_for(bench, w["name"],
                                                       "per_layer")]
        assert ("later_metric.x" in names) == (w["name"] in moves["workloads"])


def test_benchmark_json_keeps_to_the_contract():
    bench = common.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_h100"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/")
        assert (ROOT / c["file"]).is_file()
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert common.traffic_file(ROOT, w["traffic"]).is_file()
        cells.add(w["name"])
    seen = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "bench_h100" / "layer_metrics"
                / f"{m['name']}.py").is_file()
    for w in cells:
        assert common.metrics_for(bench, w, "per_layer")
        assert len(common.metrics_for(bench, w, "end_to_end")) >= 2
    assert len(json.dumps(bench)) < 64 * 1024


def test_readers_return_nothing_where_nothing_was_read():
    bench = common.load_benchmark(ROOT)
    for m in bench["per_layer"]:
        assert common.load_reader(ROOT, m["name"])({}) is None


def test_readers_on_counted_values():
    read = lambda name, ctx: common.load_reader(ROOT, name)(ctx)  # noqa
    c = {"serving_items_total": 300.0, "serving_padded_items_total": 100.0,
         "serving_device_dispatches_total": 20.0,
         "serving_device_seconds_sum": 0.4}
    assert read("coalesced_items.serve", {"counters": c}) == 15.0
    assert read("padded_share.serve", {"counters": c}) == 25.0
    assert read("dispatch_ms.serve", {"counters": c}) == pytest.approx(20.0)
    assert read("mfu.serve", {"counters": c, "forward_flops": 1e9,
                              "peak_flops": 1e12}) == pytest.approx(100.0)
    t = trace.Summary(window_s=2.0, busy_s=0.5, kernels={
        "void saliency_summary_kernel<float>": [4, 4e-5]},
        idle_by_host={"x": 1.5})
    assert read("idle_share.train", {"trace": t}) == 75.0
    share = read("head_roofline.train", {"trace": t, "head_shape": {
        "b": 8, "n": 49, "f": 2048, "c": 393, "p": 1, "x_bytes": 4}})
    assert 0 < share <= 100


def test_trace_summary_of_events():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 20,
           "dur": 15},
          {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 0,
           "dur": 100}]
    s = trace.summarize(ev, 1e-4)
    assert s.busy_s == pytest.approx(25e-6)
    assert s.kernels["k1"] == [2, pytest.approx(20e-6)]
    assert s.idle_by_host == {"op aten::mm": pytest.approx(25e-6)}
    assert s.breakdown()["device_ops"][0][0] == "k1"


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    assert common.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert common.forbidden_loaded(
        ["attentionalpoolingaction_torch.train",
         "attentionalpoolingaction_tpu_x"]) == []
    assert common.forbidden_loaded(
        ["attentionalpoolingaction_tpu.models"]) == [
        "attentionalpoolingaction_tpu"]


def run_cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "mpii224_http_poisson", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, **(env or {})))


def test_a_run_with_no_card_fails_and_prints_no_result():
    out = run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_a_run_with_the_benchmark_alone_fails(tmp_path):
    copy_benchmark(tmp_path)
    out = run_cli(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and "{" not in out.stdout
