"""The knee of an HTTP cell: offered rates in turn against one server in
one process, each after a warm-up at that rate.

    python3 bench_h100/tools/knee_sweep.py --workload <name> --seed <n> \\
        --seconds 8 --rates 200 300 400

The knee is the highest offered rate at which the answered rate (every
answer that came back inside the window, over its length) stays
within 2% of the offered one and the queue does not grow over the window
(the median latency of its last quarter within 1.5x of its first
quarter's).  One JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from bench_h100 import common  # noqa: E402
from bench_h100 import run as bench_run  # noqa: E402
from bench_h100.cell import make_weights, port_config  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    common.cache_env()
    from bench_h100.drivers import serve_http as sh
    from bench_h100.generators import images as gen_images
    with tempfile.TemporaryDirectory(prefix="bench_h100_") as d:
        ctx = bench_run.make_context(argparse.Namespace(
            workload=a.workload, seed=a.seed, seconds=a.seconds, trace=0),
            tmpdir=d)
        tr = ctx.traffic
        cfg = port_config(ctx)
        params, stats = make_weights(cfg, a.seed, ctx.device)
        served = sh.Served(cfg, params, stats, tr["server"], ctx.device)
        pool = gen_images.make_pool(a.seed, tr["mix"],
                                    int(tr["pool_images"]),
                                    int(tr["jpeg_quality"]))
        try:
            for rate in a.rates:
                res = sh.serve_window(
                    served, pool, seed=a.seed, rate=rate,
                    warm_s=float(tr["warm_seconds"]), seconds=a.seconds,
                    connections=int(tr["connections"]), tmpdir=d)
                lat = res["latency_s"] * 1e3
                due = res["due_s"]
                q = a.seconds / 4
                first = np.median(lat[due < q]) if (due < q).any() else 0
                last = (np.median(lat[due >= 3 * q]) if (due >= 3 * q).any()
                        else 0)
                done = res["answered_in_window"] / res["window_s"]
                c = res["counters"]
                n = c.get("serving_device_dispatches_total", 0) or 1
                line = {"rate": rate, "completed_per_s": done,
                        "p50_ms": sh.nearest_rank(lat, 0.5),
                        "p95_ms": sh.nearest_rank(lat, 0.95),
                        "p99_ms": sh.nearest_rank(lat, 0.99),
                        "first_quarter_p50_ms": float(first),
                        "last_quarter_p50_ms": float(last),
                        "failed": int((~res["ok"]).sum()),
                        "p95_ms_by_quarter": sh.by_part(
                            lat, due, a.seconds, 4, 0.95),
                        "items_a_dispatch": c.get("serving_items_total", 0)
                        / n,
                        "dispatch_ms": 1e3 * c.get(
                            "serving_device_seconds_sum", 0) / n,
                        "lateness_ms": res["lateness"],
                        "sustained": bool(done >= 0.98 * rate
                                          and last <= 1.5 * max(first, 1e-9))}
                print(json.dumps(line), flush=True)
        finally:
            served.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
