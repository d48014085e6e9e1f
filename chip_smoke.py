#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases; any failure raises and the process exits non-zero:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Kernels: builds csrc/attn_pool.cu with nvcc (sm_90a), prints its
   registers and spills, and holds each kernel against its plain PyTorch
   version at the serving shapes (B in {1, 8, 32}, N=49, F=2048, C=393,
   P=1), at rank 5 (B=8; N=196, C=600 and N=225, C=393) and at the
   hmdb51_clip8 clip (B=8, N=392, C=51, P=1), each with float32 and
   bfloat16 X.  Checks that two launches give the same bits.  Prints, per
   case, each kernel's launch plan, and for each kernel and for the
   fused_pool_logits pair the error, the kernel's, the plain version's
   and the library composition's times, the bound and the share of it,
   beside the timer's own floor.
3. Serving: the ``mpii_rank1_224`` Predictor (ResNet-101, 393 classes,
   rank 1, 224 px, float32, buckets 1/8/32) with seeded random weights in
   the Flax layout, carried across by the weight bridge.  12 concurrent
   single-image requests through the DynamicBatcher and one 40-image
   predict_arrays call; checks the probabilities, that both kernels ran
   once per dispatch, and the logits of 2 images against the CPU plain
   path; prints images/s and the median and p90 time of a call at each
   bucket.
4. A ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler breakdown of a call at each bucket.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.ops import _build
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc
from attentionalpoolingaction_torch.train import build_model, normalize_images

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the tensor
# cores (the kernels' FMAs are float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
KERNEL_RTOL = 1e-5      # kernel vs plain, of the largest |output|
CPU_RTOL = 5e-4         # card vs CPU logits through ResNet-101, no TF32
SOURCE = "attentionalpoolingaction_torch/csrc/attn_pool.cu"
REPLACES = {
    "saliency_summary":
        "attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:100",
    "project_logits":
        "attentionalpoolingaction_tpu/ops/attn_pool_pallas.py:137",
}


def log(*args):
    print(*args, flush=True)


# -- timing ------------------------------------------------------------------

class ColdTimer:
    """Device time of one call, median of ``iters``, with L2 flushed
    before each by a 256 MB write.  A ~1 ms device sleep after the flush
    keeps the card busy while the host enqueues the call, so that the
    events see the call's device time and not the host's launch latency."""

    def __init__(self):
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, iters=20, warm=3):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times]))


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want):
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale), \
        float((got - want).abs().max())


# -- phase 1 -----------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; the port "
                 "runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return card


# -- phase 2 -----------------------------------------------------------------

def make_case(b, n, c, p, x_dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = 2048

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    x = randn(b, n, f).relu().to(x_dtype)     # post-ReLU features
    return {"x": x, "attn_w": randn(f, c, p, std=0.02),
            "attn_b": randn(c, p, std=0.1), "sal_w": randn(f, p, std=0.02),
            "sal_b": randn(p, std=0.1)}


def library_saliency(x, sal_w, sal_b):
    """cuBLAS in the input dtype: the einsum composition as a yardstick."""
    s = torch.einsum("bnf,fp->bpn", x, sal_w.to(x.dtype)) + sal_b[:, None]
    return torch.einsum("bpn,bnf->bpf", s.to(x.dtype), x), s


def library_project(v, s, w_pfc, attn_b):
    b, c = v.shape[0], w_pfc.shape[2]
    return torch.addmm(s.sum(2) @ attn_b.t(), v.reshape(b, -1),
                       w_pfc.reshape(-1, c))


def library_fused(x, sal_w, sal_b, w_pfc, attn_b):
    """The whole of fused_pool_logits by the library calls above; v goes
    to float32 for the projection, as the kernels keep it."""
    v, s = library_saliency(x, sal_w, sal_b)
    return library_project(v.float(), s, w_pfc, attn_b)


def phase_kernels(timer):
    t0 = time.monotonic()
    _build.load()
    log(f"built {_build.library_path().name} in "
        f"{time.monotonic() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  nvcc:", line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    log("torch.backends.cuda.matmul.allow_tf32 = False (plain and library "
        "versions in full float32)")

    log(f"ColdTimer floor (an empty kernel between its events): "
        f"{timer(lambda: torch.cuda._sleep(1)):.4f} ms")
    cases = [(b, 49, 393, 1, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8, 32)]
    cases += [(8, n, c, 5, dt) for n, c in ((196, 600), (225, 393))
              for dt in (torch.float32, torch.bfloat16)]
    # the hmdb51_clip8 clip: 8 frames of 7x7 positions folded into N
    cases += [(8, 392, 51, 1, dt) for dt in (torch.float32, torch.bfloat16)]
    rows = []
    log("case                        kernel            rel_err   "
        "ms       plain_ms  lib_ms    bound_ms  share")
    for i, (b, n, c, p, dt) in enumerate(cases):
        a = make_case(b, n, c, p, dt, seed=i)
        w_pfc = apc.attn_w_pfc(a["attn_w"])
        x, sw, sb, ab = a["x"], a["sal_w"], a["sal_b"], a["attn_b"]
        f = x.shape[2]
        sp = apc.saliency_plan(b, n, f, p, dt)
        pp = apc.project_plan(b, n, f, c, p)
        with torch.no_grad():
            v, s = apc.saliency_summary(x, sw, sb)
            sal_clusters = _build.load().apa_last_active_clusters()
            pv, ps = apc.saliency_summary_plain(x, sw, sb)
            plog = apc.project_logits_plain(pv, ps, w_pfc, ab)
            # the projection runs on the plain summary, so that its error
            # is its own
            logits = apc.project_logits(pv, ps, w_pfc, ab)
            proj_clusters = _build.load().apa_last_active_clusters()
        log(f"plans: saliency cluster {sp.cluster} x {sp.f_slice} columns, "
            f"{sp.path}, r2 {sp.r2}, {sp.smem_bytes} B, {sp.grid} CTAs, "
            f"{sal_clusters} clusters at once; projection K split "
            f"{pp.k_split} x {pp.k_rows} rows, image tile {pp.b_tile}, "
            f"A {'resident' if pp.a_resident else 'streamed'}, "
            f"{pp.smem_bytes} B, grid {pp.grid}, {proj_clusters} clusters "
            f"at once")
        with torch.no_grad():
            fused = apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                          w_pfc=w_pfc)
            again = apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                          w_pfc=w_pfc)
            torch.cuda.synchronize()
            if not all(torch.equal(u, w) for u, w in zip(fused, again)):
                raise AssertionError(
                    f"two launches at B{b} N{n} C{c} P{p} {dt} gave "
                    f"different bits")
            errs = {"saliency_summary": max(rel_err(v, pv), rel_err(s, ps)),
                    "project_logits": rel_err(logits, plog),
                    "fused_pool_logits": max(
                        rel_err(fused[0], plog), rel_err(fused[1], pv),
                        rel_err(fused[2], ps))}
            xbytes = x.numel() * x.element_size()
            sal_bytes = xbytes + 4 * (f * p + p + b * p * (f + n))
            sal_flops = 4 * b * n * f * p
            proj_bytes = 4 * (b * p * (f + n) + p * f * c + c * p + b * c)
            proj_flops = 2 * b * p * f * c + b * p * n + 2 * b * c * p
            timings = {
                "saliency_summary": (
                    lambda: apc.saliency_summary(x, sw, sb),
                    lambda: apc.saliency_summary_plain(x, sw, sb),
                    lambda: library_saliency(x, sw, sb),
                    bound_ms(sal_bytes, sal_flops)),
                "project_logits": (
                    lambda: apc.project_logits(v, s, w_pfc, ab),
                    lambda: apc.project_logits_plain(v, s, w_pfc, ab),
                    lambda: library_project(v, s, w_pfc, ab),
                    bound_ms(proj_bytes, proj_flops)),
                # the pair as the head calls it; v and s count once, as
                # outputs, and A once
                "fused_pool_logits": (
                    lambda: apc.fused_pool_logits(x, a["attn_w"], ab, sw, sb,
                                                  w_pfc=w_pfc),
                    lambda: apc.project_logits_plain(
                        *apc.saliency_summary_plain(x, sw, sb), w_pfc, ab),
                    lambda: library_fused(x, sw, sb, w_pfc, ab),
                    bound_ms(sal_bytes + 4 * (p * f * c + c * p + b * c),
                             sal_flops + proj_flops)),
            }
            for name, (kern, plain, lib, (bms, by)) in timings.items():
                rel, absd = errs[name]
                row = {"case": {"B": b, "N": n, "F": f, "C": c, "P": p,
                                "x": str(dt).removeprefix("torch.")},
                       "name": name, "rel_err": rel, "max_abs_err": absd,
                       "ms": timer(kern), "plain_ms": timer(plain),
                       "library_ms": timer(lib), "bound_ms": bms,
                       "bound_by": by}
                row["bound_share"] = bms / row["ms"]
                rows.append(row)
                log(f"B{b:<3} N{n:<4} C{c:<4} P{p} {row['case']['x']:<9}"
                    f"{name:<18}{rel:<10.2e}{row['ms']:<9.4f}"
                    f"{row['plain_ms']:<10.4f}{row['library_ms']:<10.4f}"
                    f"{bms:<10.4f}{row['bound_share']:.1%}")
                if not rel < KERNEL_RTOL:
                    raise AssertionError(
                        f"{name} disagrees with its plain version at "
                        f"{row['case']}: relative error {rel:.2e} >= "
                        f"{KERNEL_RTOL}")
    return rows


# -- phase 3 -----------------------------------------------------------------

def phase_serving(card):
    cfg = config_lib.get_config("mpii_rank1_224")
    params, stats = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=49,
        seed=0)
    t0 = time.monotonic()
    pred = serving.Predictor(cfg, params, stats, buckets=(1, 8, 32))
    pred.warmup()
    log(f"predictor {cfg.backbone} {cfg.image_size}px rank {cfg.rank} "
        f"built and warmed in {time.monotonic() - t0:.1f} s "
        f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")
    rng = np.random.default_rng(0)
    singles = rng.integers(0, 256, (12, 224, 224, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (40, 224, 224, 3), dtype=np.uint8)

    # -- the main path, counted ---------------------------------------------
    batcher = serving.DynamicBatcher(pred.predict_preprocessed, max_batch=32,
                                     max_wait_ms=20.0)
    d0 = pred.stats.snapshot().get("serving_device_dispatches_total", 0)
    apc.reset_launch_counts()
    results = [None] * len(singles)

    def client(i):
        results[i] = batcher.submit(singles[i]).result(timeout=120)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    probs = pred.predict_arrays(batch)
    torch.cuda.synchronize()
    launches = dict(apc.launch_counts)
    dispatches = int(pred.stats.snapshot()["serving_device_dispatches_total"]
                     - d0)
    batcher.stop()

    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a batcher request did not complete")
    for r in results:
        p_top = [e["prob"] for e in r["topk"]]
        if not (len(p_top) == 5 and np.isfinite(p_top).all()):
            raise AssertionError(f"bad batcher result {r}")
    if probs.shape != (40, 393) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities, shape {probs.shape}")
    if not np.allclose(probs.sum(-1), 1.0, atol=1e-4):
        raise AssertionError("probabilities do not sum to 1")
    log(f"batcher: 12 requests in "
        f"{int(batcher.stats.snapshot()['serving_coalesced_batches_total'])}"
        f" coalesced batches; predict_arrays(40): 2 chunks; "
        f"{dispatches} dispatches; launches {launches}")
    if launches != {"saliency_summary": dispatches,
                    "project_logits": dispatches} or dispatches < 3:
        raise AssertionError(
            f"kernel launches {launches} != forward dispatches {dispatches}")

    # -- card vs the CPU plain path, no TF32 --------------------------------
    torch.backends.cudnn.allow_tf32 = False
    two = batch[:2]
    card_logits = pred._fwd(pred._weights, two)
    cpu_model = build_model(cfg, device="cpu")
    convert.load_flax_variables(cpu_model, params, stats)
    with torch.no_grad():
        cpu_logits = cpu_model(
            normalize_images(torch.from_numpy(two)))["logits"].numpy()
    err = np.abs(card_logits - cpu_logits).max() / np.abs(cpu_logits).max()
    log(f"card vs CPU logits (2 images, no TF32): relative error {err:.2e} "
        f"(tolerance {CPU_RTOL:g}), max |logit| "
        f"{np.abs(cpu_logits).max():.3f}")
    if not err < CPU_RTOL:
        raise AssertionError(f"card logits disagree with CPU: {err:.2e}")
    torch.backends.cudnn.allow_tf32 = True

    # -- latency and throughput by bucket (cuDNN's default TF32) -----------
    for size in pred.buckets:
        imgs = batch[:size]
        for _ in range(3):
            pred.predict_arrays(imgs)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.predict_arrays(imgs)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        log(f"serving bucket {size}: {size / med:.1f} images/s, median "
            f"{med * 1e3:.3f} ms a call (p90 {np.percentile(times, 90) * 1e3:.3f}"
            f" ms; uint8 in, probabilities out, cudnn TF32 on) on {card}")
    return pred, launches


def phase_profile(pred):
    """Device time of a predict_arrays call at each bucket, by kernel, and
    the device's busy share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 5
    for size in pred.buckets:
        imgs = np.zeros((size, 224, 224, 3), np.uint8)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                pred.predict_arrays(imgs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # only the device's own events: an aten op's device time is its
        # kernels' time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events) / 1e3 / reps
        log(f"profile: bucket-{size} predict_arrays, {wall_ms:.3f} ms wall, "
            f"{total:.3f} ms device time a call (device busy "
            f"{total / wall_ms:.1%}), "
            f"{sum(e.count for e in events) // reps} device events")
        if total == 0:
            raise AssertionError("the profiler saw no device time")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            ms = e.self_device_time_total / 1e3 / reps
            log(f"  {ms / total:6.1%} {ms:8.3f} ms  {e.count // reps:4d}x  "
                f"{e.key[:80]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a profiler breakdown of a call at "
                        "each bucket")
    args = parser.parse_args()

    card = phase_device()
    timer = ColdTimer()
    rows = phase_kernels(timer)
    pred, launches = phase_serving(card)
    if args.profile:
        phase_profile(pred)

    kernels = []
    for name in ("saliency_summary", "project_logits"):
        mine = [r for r in rows if r["name"] == name]
        main_row = next(r for r in mine if r["case"]["B"] == 32
                        and r["case"]["x"] == "float32")
        slice_rows = [r for r in mine if r["case"]["N"] == 49]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in slice_rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "bound_share": main_row["bound_share"]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
