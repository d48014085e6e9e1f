#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 bench_h100/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; then ``checks``, each number compared with its limit,
which are also the last lines of standard error.  Exits non-zero with no
result without a CUDA card (or with fewer than the cell asks for), and
when a JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()      # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import common  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def make_context(args, root=ROOT, tmpdir=None, device="cuda",
                 shrink=None) -> common.Context:
    bench = common.load_benchmark(root)
    wl = common.find_workload(bench, args.workload)
    cfg = common.find_config(bench, wl["config"])
    return common.Context(
        workload=wl, config=cfg, config_file=common.read_json(
            root, cfg["file"]),
        traffic=json.loads(common.traffic_file(root, wl["name"])
                           .read_text()),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        tmpdir=tmpdir, device=device, shrink=dict(shrink or {}))


def check_cards(chips: int) -> str | None:
    """Why this machine cannot run the cell, or None."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA card: the benchmark does not run on the CPU"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards, this machine has "
                f"{torch.cuda.device_count()}")
    return None


def result_line(ctx: common.Context, out: common.Outcome, bench: dict,
                root=ROOT, t_start=T_START) -> dict:
    """The result object of a run (the driver's ``out``): the end-to-end
    metrics or, traced, the per-layer ones from their readers."""
    wl = ctx.workload["name"]
    metrics = {}
    if not ctx.trace:
        values = dict(out.end_to_end)
        values["setup_s"] = out.window_start - t_start
        for m in common.metrics_for(bench, wl, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        layer_ctx = dict(out.layer_ctx, trace=out.trace,
                         config_file=ctx.config_file, traffic=ctx.traffic)
        for m in common.metrics_for(bench, wl, "per_layer"):
            v = common.load_reader(root, m["name"])(layer_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    import torch
    kind = (torch.cuda.get_device_name(0) if ctx.device == "cuda"
            else "cpu")
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu",
              "kind": kind, "count": out.device_count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = out.trace.breakdown()
    line["notes"] = out.notes
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    common.cache_env()
    bench = common.load_benchmark()
    wl = common.find_workload(bench, args.workload)
    why_not = check_cards(int(wl["chips"]))
    if why_not:
        print(why_not, file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix="bench_h100_")
    try:
        ctx = make_context(args, tmpdir=tmpdir)
        driver = common.driver_module(ctx.traffic["driver"])
        out = driver.run(ctx)
        line = result_line(ctx, out, bench)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = common.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the run's process: {found}",
              file=sys.stderr)
        return 3
    print(f"card: {common.power_limit()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
