"""Driver ``serve_http``: the port's HTTP server in the run's process, an
open-loop load generator in a process of its own, and the served answers
judged against the plain reference once the window has closed.

Traffic parameters (``traffic/<workload>.json``): ``rate_per_s``,
``warm_seconds`` (load at the same rate before the window, not counted),
``connections``, ``mix`` and ``pool_images`` and ``jpeg_quality`` (the
request images, ``generators/images.py``), ``server`` (``make_server``'s
arguments and the predictor's ``buckets``), ``trace`` (``offset_s`` and
``seconds`` of the traced part of the window) and ``check`` (``sample``:
answers compared; ``limits``).

A request is timed from its due time to the last byte of its answer; one
that failed, was refused or had no answer by ``deadline_s`` after the
window counts as answered at that deadline (so it lies beyond every
served request's time).  The answered rate is every answer of status 200
whose last byte came inside the window, over the window's length.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from bench_h100 import common, roofline
from bench_h100.cell import make_weights, num_classes, port_config
from bench_h100.generators import images as gen_images
from bench_h100.generators import schedule
from bench_h100.generators import weights as gen_weights
from bench_h100.reference import compare
from bench_h100.reference import model as ref_model
from bench_h100.reference import preprocess as ref_pre

DEADLINE_S = 60.0


def nearest_rank(values: np.ndarray, q: float) -> float:
    v = np.sort(np.asarray(values, np.float64))
    return float(v[max(int(np.ceil(q * len(v))) - 1, 0)])


class Served:
    """A predictor behind ``serve_cli.make_server`` on a thread."""

    def __init__(self, cfg, params, stats, server_args: dict, device):
        from attentionalpoolingaction_torch import serve_cli, serving
        self.pred = serving.Predictor(
            cfg, gen_weights.to_numpy(params), gen_weights.to_numpy(stats),
            buckets=tuple(server_args["buckets"]), device=device)
        self.pred.warmup()
        kw = {k: v for k, v in server_args.items() if k != "buckets"}
        self.server = serve_cli.make_server(self.pred, "127.0.0.1", 0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, kwargs={"poll_interval": 0.05},
            name="bench-http", daemon=True)
        self.thread.start()

    def stop(self):
        from attentionalpoolingaction_torch import serve_cli
        serve_cli.stop_server(self.server)
        self.thread.join(timeout=30)


def write_pool(pool: list[dict], path: str) -> list[int]:
    offsets = [0]
    with open(path, "wb") as f:
        for img in pool:
            f.write(img["data"])
            offsets.append(offsets[-1] + len(img["data"]))
    return offsets


def serve_window(served: Served, pool: list[dict], *, seed: int, rate: float,
                 warm_s: float, seconds: float, connections: int,
                 tmpdir: str, tracer=None, trace_at=(0.0, 0.0)) -> dict:
    """One open-loop window at ``rate`` after ``warm_s`` of warm load:
    its requests (due times, pool images, answers, latencies), the
    serving counters' deltas over the window and its start."""
    warm = schedule.poisson(rate, warm_s, stream=1)
    win = warm_s + schedule.poisson(rate, seconds, stream=0)
    times = np.concatenate([warm, win])
    picks = schedule.picks(seed, len(times), len(pool))
    pool_file = os.path.join(tmpdir, "pool.bin")
    offsets = write_pool(pool, pool_file)
    start = time.monotonic() + 1.0
    spec = {"port": served.port, "start": start, "times": times.tolist(),
            "images": picks.tolist(), "pool_file": pool_file,
            "offsets": offsets, "connections": connections,
            "deadline_s": warm_s + seconds + DEADLINE_S}
    spec_path = os.path.join(tmpdir, "loadgen_spec.json")
    out_path = os.path.join(tmpdir, "loadgen_out.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bench_h100.drivers.loadgen", "--spec",
         spec_path, "--out", out_path], cwd=str(common.ROOT),
        env=dict(os.environ, PYTHONPATH=str(common.ROOT)))
    stats = served.pred.stats
    try:
        _sleep_until(start + warm_s)
        window_start = time.monotonic()
        before = stats.snapshot()
        if tracer is not None:
            _sleep_until(window_start + trace_at[0])
            tracer.start()
            _sleep_until(window_start + trace_at[0] + trace_at[1])
            tracer.stop()
        _sleep_until(window_start + seconds)
        window_end = time.monotonic()
        after = stats.snapshot()
        proc.wait(timeout=warm_s + seconds + DEADLINE_S + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"load generator exited {proc.returncode}")
    with open(out_path) as f:
        res = json.load(f)
    n_warm = len(warm)
    idx = np.arange(n_warm, len(times))
    status = np.asarray(res["status"])[idx]
    due = start + times[idx]
    done = np.asarray(res["done"])[idx]
    ok = status == 200
    lat = np.where(ok, done - due, warm_s + seconds + DEADLINE_S
                   - times[idx])
    delta = {k: after.get(k, 0.0) - before.get(k, 0.0)
             for k in set(after) | set(before)}
    all_ok = np.asarray(res["status"]) == 200
    all_done = np.asarray(res["done"])
    answered = int((all_ok & (all_done >= window_start)
                    & (all_done <= window_end)).sum())
    return {"index": idx, "picks": picks[idx], "ok": ok, "latency_s": lat,
            "bodies": [res["body"][i] for i in idx], "counters": delta,
            "window_start": window_start, "window_s": window_end
            - window_start, "lateness": res["lateness"],
            "answered_in_window": answered,
            "due_s": times[idx] - warm_s}


def parts(due_s: np.ndarray, seconds: float, n: int) -> list:
    """Masks of the requests due in each ``n``-th of the window."""
    edges = np.linspace(0.0, seconds, n + 1)
    return [(due_s >= lo) & (due_s < hi) for lo, hi in zip(edges, edges[1:])]


def by_part(lat_ms: np.ndarray, due_s: np.ndarray, seconds: float, n: int,
            q: float) -> list:
    """The ``q`` quantile of the requests due in each ``n``-th of the
    window: how the tail reads over shorter windows."""
    return [nearest_rank(lat_ms[m], q) if m.any() else None
            for m in parts(due_s, seconds, n)]


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def reference_crops(cfg, datas: list[bytes]) -> np.ndarray:
    """The reference's uint8 eval crops of JPEG ``datas`` (OpenCV)."""
    return np.stack([ref_pre.eval_crop(d, cfg.image_size,
                                       cfg.resize_min_resolved)
                     for d in datas])


def reference_logits(cfg, seed: int, crops: np.ndarray, device,
                     dtype=None) -> np.ndarray:
    """The plain reference's float64 logits of uint8 ``crops`` (float32
    with TF32 off, or ``dtype``), in blocks."""
    import torch
    params, stats = make_weights(cfg, seed, device)
    stages = gen_weights.STAGES[cfg.backbone]
    out = []
    with torch.no_grad(), ref_model.exact_float32():
        for lo in range(0, len(crops), 32):
            x = torch.from_numpy(crops[lo:lo + 32]).to(device)
            lg, _ = ref_model.logits(params, stats, x, stages=stages,
                                     dtype=dtype or torch.float32)
            out.append(lg.double().cpu().numpy())
    return np.concatenate(out)


def sample_answers(res: dict, seed: int, k: int) -> np.ndarray:
    """Indices (into the window's requests) of ``k`` answered requests,
    drawn from the seed."""
    ok = np.flatnonzero(res["ok"])
    rng = np.random.default_rng([seed, 6])
    return np.sort(rng.choice(ok, size=min(k, len(ok)), replace=False))


def sampled_images(res: dict, seed: int, check: dict) -> tuple:
    """The sampled requests and the pool images they sent."""
    take = sample_answers(res, seed, int(check["sample"]))
    return take, sorted({int(res["picks"][i]) for i in take})


def judge(cfg, seed: int, pool: list[dict], res: dict, check: dict,
          device, program_crops: dict) -> tuple[list, dict]:
    """A sample of the window's answers, in two stages.  The crops the
    server's byte path makes of the sampled images (``program_crops``,
    pool index -> uint8 crop) against the reference's own decode and crop:
    ``crop_pixel_gap``, the mean |difference| in levels.  The served
    answers against the reference's float32 logits of those same crops,
    in units of the gap the reference itself makes with bfloat16 convs:
    ``logprob_bf16_ratio`` (``reference.compare.bf16_ratio``).  nvJPEG
    and OpenCV put some pixels a level apart, which moves a random
    network's log-probabilities as far as bfloat16 does, so the model is
    judged on the program's own crops and the decode by itself.  The
    widest top-1 logit gap and the plain log-probability gaps are
    reported beside (``reference.compare.served_gaps``)."""
    import torch
    take, imgs = sampled_images(res, seed, check)
    answers = [json.loads(res["bodies"][i])["topk"] for i in take]
    crops = np.stack([program_crops[j] for j in imgs])
    gaps = compare.batch_gaps(
        [(crops, [])], [(reference_crops(cfg, [pool[j]["data"]
                                                for j in imgs]), [])])
    found = {"crop_pixel_gap": gaps["batch_pixel_gap"]}
    ref = reference_logits(cfg, seed, crops, device)
    low = reference_logits(cfg, seed, crops, device, dtype=torch.bfloat16)
    row = {j: r for j, r in zip(imgs, ref)}
    low_row = {j: r for j, r in zip(imgs, low)}
    refs = [row[int(res["picks"][i])] for i in take]
    found.update(compare.served_gaps(answers, refs))
    found.update(compare.bf16_ratio(
        answers, refs, [low_row[int(res["picks"][i])] for i in take]))
    limits = check["limits"]
    checks = [common.Check(k, found[k], float(v)) for k, v in limits.items()]
    if len(take) < int(check["sample"]):
        checks.append(common.Check("answers_sampled_short",
                                   float(int(check["sample"]) - len(take)),
                                   0.0))
    return checks, {k: v for k, v in found.items() if k not in limits}


def run(ctx: common.Context) -> common.Outcome:
    import torch
    from bench_h100 import trace as trace_lib
    tr = ctx.traffic
    cfg = port_config(ctx)
    dev = ctx.device
    params, stats = make_weights(cfg, ctx.seed, dev)
    served = Served(cfg, params, stats, tr["server"], dev)
    del params, stats
    pool = gen_images.make_pool(ctx.seed, tr["mix"], int(tr["pool_images"]),
                                int(tr["jpeg_quality"]))
    # the byte path on each kind of image the traffic sends, in set-up:
    # the first decode builds the nvJPEG library, which a checkout's first
    # run would otherwise do under the warm load and into the window
    kinds = {(p["width"], p["height"], p["gray"]): p for p in pool}
    for img in kinds.values():
        served.pred.preprocess(img["data"])
    tracer = trace_lib.Tracer(ctx.tmpdir) if ctx.trace else None
    try:
        res = serve_window(
            served, pool, seed=ctx.seed, rate=float(tr["rate_per_s"]),
            warm_s=float(tr["warm_seconds"]), seconds=ctx.seconds,
            connections=int(tr["connections"]), tmpdir=ctx.tmpdir,
            tracer=tracer, trace_at=(float(tr["trace"]["offset_s"]),
                                     float(tr["trace"]["seconds"])))
    finally:
        served.stop()
    peak = (torch.cuda.max_memory_allocated() if dev == "cuda" else 0)
    # the server's byte path again on the sampled images (decode and crop
    # are deterministic), for the judgement's first stage
    _, imgs = sampled_images(res, ctx.seed, tr["check"])
    program_crops = {j: served.pred.preprocess(pool[j]["data"]).cpu()
                     .numpy() for j in imgs}
    del served
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    lat_ms = 1e3 * res["latency_s"]
    checks, judged = judge(cfg, ctx.seed, pool, res, tr["check"], dev,
                           program_crops)
    flops = roofline.forward_flops(cfg.backbone, cfg.image_size,
                                   num_classes(cfg), cfg.rank)
    layer_ctx = {"counters": res["counters"], "forward_flops": flops,
                 "peak_flops": roofline.PEAK_FLOPS[
                     ctx.config_file["peak"]],
                 "window_s": res["window_s"]}
    p50, p95 = nearest_rank(lat_ms, 0.50), nearest_rank(lat_ms, 0.95)
    return common.Outcome(
        # BENCHMARK.json picks what a cell reports; the tails are here for
        # a cell whose runs hold them steady
        end_to_end={"serve_done_per_s": res["answered_in_window"]
                    / res["window_s"],
                    "serve_p50_ms": p50, "serve_p95_ms": p95},
        window_start=res["window_start"], attempted=len(lat_ms),
        failed=int((~res["ok"]).sum()), checks=checks,
        memory_peak_bytes=peak, device_count=1, layer_ctx=layer_ctx,
        trace=tracer.summary if tracer else None,
        notes={"serve_p50_ms": p50, "serve_p95_ms": p95,
               "lateness_ms": res["lateness"],
               **{f"p{int(100 * q)}_ms_by_{name}": by_part(
                   lat_ms, res["due_s"], ctx.seconds, n, q)
                  for q in (0.5, 0.95)
                  for name, n in (("half", 2), ("quarter", 4))},
               "answered_in_window": res["answered_in_window"],
               "offered": len(lat_ms), **judged})
