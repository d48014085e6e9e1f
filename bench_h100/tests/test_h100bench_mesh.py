"""The four-card cell ``mpii450_mesh4_train`` on the CPU: its entries and
configuration, its readers, its launcher, and a small run of it over two
gloo ranks (resnet_v1_50 at 64 px in float32, 2 images a rank) with its
timed path sound and with each fault a data-parallel step can have:

* ranks that skip the gradients' all-reduce, each stepping on its own;
* half of each rank's batch left out (the loss a mean over the rest);
* the decoded images with red and blue swapped;

each of which has to give ``correct`` false.
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile
import time

import pytest

from bench_h100 import common, trace
from bench_h100 import run as bench_run
from bench_h100.cell import port_config
from bench_h100.drivers import train_mesh

ROOT = pathlib.Path(common.__file__).resolve().parents[1]
CELL = "mpii450_mesh4_train"
# float32: the cell's limits are set from the card's bfloat16 backbone at
# 450 px, which a 64 px bfloat16 stand-in on the CPU does not reproduce
SMALL = {"backbone": "resnet_v1_50", "image_size": 64, "resize_min": 72,
         "resize_max": 144, "bf16_backbone": False}
READERS = ["allreduce_ms.mesh", "allreduce_exposed_ms.mesh",
           "head_roofline.mesh", "mfu.mesh", "idle_share.mesh"]


def read(name, ctx):
    return common.load_reader(ROOT, name)(ctx)


def test_the_cell_is_found_and_its_file_holds_the_preset():
    bench = common.load_benchmark(ROOT)
    wl = common.find_workload(bench, CELL)
    assert wl["chips"] == 4 and wl["config"] == "mpii_rank5_450_mesh"
    ctx = bench_run.make_context(argparse.Namespace(
        workload=CELL, seed=2 ** 31 + 5, seconds=1, trace=0),
        tmpdir="/nonexistent", device="cpu")
    assert ctx.traffic["driver"] == "train_mesh"
    cfg = port_config(ctx)
    assert (cfg.rank, cfg.image_size, cfg.batch_size) == (5, 450, 32)
    assert cfg.bf16_backbone and cfg.freeze_bn
    assert train_mesh.world_of(train_mesh.mesh_config(ctx)) == 4
    # every cut is named in reduced, against the preset as published
    from attentionalpoolingaction_torch import config as config_lib
    preset = config_lib.get_config("mpii_rank5_450_mesh")
    assert (preset.mesh_shape, preset.batch_size) == ((8,), 64)
    assert set(ctx.config_file["overrides"]) == set(
        ctx.config_file["reduced"]) == set(
        common.find_config(bench, "mpii_rank5_450_mesh")["reduced"])
    names = {m["name"] for m in common.metrics_for(bench, CELL,
                                                   "per_layer")}
    assert names == set(READERS)
    assert [m["name"] for m in common.metrics_for(
        bench, CELL, "end_to_end")] == ["train_images_per_s", "setup_s"]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_returns_nothing_where_nothing_was_read(name):
    assert read(name, {}) is None


def test_a_port_with_no_all_reduce_span_reads_nothing():
    # the parent's port, traced: its steps have spans, its exchange none
    t = trace.Summary(window_s=1.0, busy_s=0.5, kernels={},
                      idle_by_host={})
    assert read("allreduce_ms.mesh", {"trace": t, "span_totals": {
        "train.step": {"count": 12, "seconds": 1.2}}}) is None


def test_the_readers_on_counted_values():
    t = trace.Summary(window_s=2.0, busy_s=0.5, kernels={
        "void saliency_summary_kernel<float, 5, 4, false>": [12, 1.2e-3],
        "pool_backward_kernel<float, 5, 4, false>": [12, 2.4e-3]},
        idle_by_host={})
    totals = {"train.step": {"count": 12, "seconds": 1.2},
              "train.all_reduce": {"count": 12, "seconds": 0.06,
                                   "bytes": 12 * 4000, "buckets": 36}}
    ctx = {"trace": t, "span_totals": totals, "nccl_exposed_s": 0.024,
           "traced_steps": 12, "images": 3200, "window_s": 10.0,
           "cards": 4, "train_flops": 3 * 61.68e9, "peak_flops": 989e12,
           "head_shape": {"b": 8, "n": 225, "f": 2048, "c": 393, "p": 5,
                          "x_bytes": 4}}
    assert read("allreduce_ms.mesh", ctx) == pytest.approx(5.0)
    assert read("allreduce_exposed_ms.mesh", ctx) == pytest.approx(2.0)
    assert read("idle_share.mesh", ctx) == pytest.approx(75.0)
    assert read("mfu.mesh", ctx) == pytest.approx(
        100 * 320 * 3 * 61.68e9 / (4 * 989e12))
    share = read("head_roofline.mesh", ctx)
    assert share == pytest.approx(read("head_roofline.train", ctx))
    assert 0 < share <= 100


def test_nccl_exposure_of_a_synthetic_trace():
    def k(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        # 0-100: the all-reduce; a GEMM covers 20-50 and a copy 40-60
        k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 100),
        k("sm90_xmma_gemm", 20, 30), k("Memcpy HtoD", 40, 20, "gpu_memcpy"),
        # 200-230: a second one, alone; a third 300-310 inside a kernel
        k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 200, 30),
        k("elementwise", 290, 40),
        k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 300, 10),
        # host events and instants count for nothing
        {"ph": "X", "cat": "cpu_op", "name": "nccl:all_reduce", "ts": 0,
         "dur": 400}, {"ph": "i", "cat": "kernel", "name": "nccl", "ts": 0}]
    assert train_mesh.nccl_exposed_seconds(events) == pytest.approx(
        (100 - 40 + 30) * 1e-6)
    assert train_mesh.nccl_exposed_seconds([]) == 0.0


STUB = r"""
import os, sys, time
rank = int(os.environ["RANK"])
with open(os.path.join(os.environ["STUB_PID_DIR"], f"{rank}.pid"), "w") as f:
    f.write(str(os.getpid()))
if rank == int(sys.argv[1]):
    time.sleep(0.5)
    sys.exit(3)
time.sleep(float(sys.argv[2]))
"""


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("fails", [0, 2])
def test_the_launcher_stops_every_worker_when_one_fails(tmp_path, fails,
                                                       monkeypatch):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setenv("STUB_PID_DIR", str(tmp_path))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=f"worker {fails} exited 3"):
        train_mesh.launch([sys.executable, str(stub), str(fails), "60"], 4,
                          logdir=str(tmp_path), timeout=30,
                          one_card_each=False)
    assert time.monotonic() - t0 < 20
    pids = [int(p.read_text()) for p in
            (tmp_path / f"{r}.pid" for r in range(4)) if p.exists()]
    assert len(pids) == 4 and not any(alive(p) for p in pids)


def test_the_launcher_stops_every_worker_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="outlived 2 s"):
        train_mesh.launch([sys.executable, "-c",
                           "import time; time.sleep(60)"], 3,
                          logdir=str(tmp_path), timeout=2,
                          one_card_each=False)
    assert time.monotonic() - t0 < 15


FAULTS = {
    "no_all_reduce": """
from attentionalpoolingaction_torch.parallel import mesh as mesh_lib
mesh_lib.all_reduce_flat = lambda tensors, group=None, **kw: 0
""",
    "half_the_batch": """
from attentionalpoolingaction_torch import train as train_lib
make = train_lib.make_loss_fn
def halved(spec, cfg, group=None):
    fn = make(spec, cfg, group)
    def loss_fn(model, batch, train):
        k = max(batch["image"].shape[0] // 2, 1)
        return fn(model, {n: v[:k] for n, v in batch.items()}, train)
    return loss_fn
train_lib.make_loss_fn = halved
""",
    "image_altered": """
from attentionalpoolingaction_torch import train as train_lib
to_device = train_lib.batch_to_device
def swapped(batch, device):
    out = to_device(batch, device)
    return dict(out, image=out["image"].flip(-1).contiguous())
train_lib.batch_to_device = swapped
""",
}


def small_run(monkeypatch, fault=None, seed=2 ** 31 + 77) -> dict:
    with tempfile.TemporaryDirectory() as d:
        ctx = bench_run.make_context(argparse.Namespace(
            workload=CELL, seed=seed, seconds=1.0, trace=0), tmpdir=d,
            device="cpu", shrink=SMALL)
        # two gloo ranks of 2 images each
        ctx.config_file["overrides"] = {"mesh_shape": [2], "batch_size": 4}
        ctx.config_file["config"]["batch_size"] = 4
        ctx.traffic.update(records=16, pool_images=4, warm_steps=4,
                           timeout_s=240)
        if fault is not None:
            script = pathlib.Path(d, "faulty_worker.py")
            script.write_text(
                "import sys\nsys.path.insert(0, %r)\n" % str(ROOT)
                + "import torch\ntorch.set_num_threads(2)\n"
                + FAULTS[fault]
                + "from bench_h100.drivers import train_mesh\n"
                  "sys.exit(train_mesh.worker_main(sys.argv[1]))\n")
            monkeypatch.setattr(train_mesh, "worker_argv", lambda p: [
                sys.executable, str(script), p])
        monkeypatch.setenv("OMP_NUM_THREADS", "2")
        out = train_mesh.run(ctx)
        return bench_run.result_line(ctx, out, common.load_benchmark(ROOT))


def test_a_sound_small_run_is_correct(monkeypatch):
    line = small_run(monkeypatch)
    assert line["correct"] is True, json.dumps(line["checks"])
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == 2
    checks = line["checks"]
    assert checks["replica_gap"]["value"] == 0.0
    assert checks["bn_stats_moved"]["value"] == 0.0
    assert checks["init_mismatch"]["value"] == 0.0
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_is_not_correct(monkeypatch, fault):
    line = small_run(monkeypatch, fault)
    assert line["correct"] is False, json.dumps(line["checks"])


def test_the_workers_die_with_the_launcher(tmp_path):
    """A launcher ended from outside (the harness's time limit) takes its
    workers with it."""
    import signal
    import subprocess
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    launcher = tmp_path / "launcher.py"
    launcher.write_text(
        "import sys\nsys.path.insert(0, %r)\n" % str(ROOT)
        + "from bench_h100.drivers import train_mesh\n"
        + "train_mesh.launch([sys.executable, %r, '-1', '60'], 3, "
          "logdir=%r, timeout=60, one_card_each=False)\n"
        % (str(stub), str(tmp_path)))
    proc = subprocess.Popen([sys.executable, str(launcher)],
                            env=dict(os.environ, STUB_PID_DIR=str(tmp_path)))
    paths = [tmp_path / f"{r}.pid" for r in range(3)]
    deadline = time.monotonic() + 30
    while not all(p.exists() and p.read_text() for p in paths):
        assert time.monotonic() < deadline
        time.sleep(0.1)
    pids = [int(p.read_text()) for p in paths]
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    deadline = time.monotonic() + 10
    while any(alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(alive(p) for p in pids)
