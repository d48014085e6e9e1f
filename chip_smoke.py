#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases; any failure raises and the process exits non-zero:

1. Device: a CUDA card must be present; prints its name and power limit.
2. Kernels: builds csrc/attn_pool.cu with nvcc (sm_90a), prints its
   registers and spills, and holds each kernel against its plain PyTorch
   version at the serving and eval shapes (B in {1, 8, 16, 32, 48}: the
   serving buckets, an eval batch and a 3-crop eval batch; N=49, F=2048,
   C=393, P=1), at rank 5 (B=8; N=196, C=600 and N=225, C=393) and at the
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
   Phase 2 also holds the gradients of ``AttentionalPoolFn`` (the kernels'
   forward, ``fused_pool_backward``) against torch autograd through the
   plain forward at every case, and times the backward beside it.
4. Training: the ``mpii_rank1_224`` preset at full width (ResNet-101,
   224 px, batch 8, float32, BN in train mode, staircase exponential
   schedule, SGD momentum, clip 10) from seeded random weights in the Flax
   layout.  One step on the card and on the CPU from the same weights and
   batch, TF32 off, compared; 10 timed steps with cuDNN's default TF32
   (median step ms, images/s); then ``train.train`` for 8 steps, counted:
   each kernel launches once a forward, loss and parameters stay finite.
   A second, small case: the ``__graft_entry__.py`` config without its
   mesh (resnet_v1_50, 64 px, pose attention, rank 2, EMA 0.999, two
   microbatches a step), 2 steps card vs CPU, each kernel twice a step.
5. The checkpointed run: ``mpii_rank1_224`` at full width in a temporary
   workdir, deleted at the end.  The seeded Flax-layout weights are saved
   as a port checkpoint and the run warm-starts from it
   (``init_checkpoint``).  ``train.train`` with a ``CheckpointManager``
   (every 2 steps, 2 kept) gets a real SIGTERM from a hook at step 3: it
   must stop there with steps {2, 3} on disk, and step 3 restored into a
   fresh state must equal the live one bitwise; a second call resumes at
   3 and runs to 6, keeping {4, 6}.  Prints the time of a save and of a
   restore and the bytes of a step.  Then ``evaluate`` of step 6 over a
   seeded 40-image uint8 MPII eval set (batches of 16, the last padded
   with mask 0) on the card, against the same weights on the CPU (TF32
   off), a 3-crop multicrop pass card vs CPU in the same way, and the
   eval loop's images/s pipelined and serialized; ``BestKeeper`` twice (the second lower),
   ``load_predictor(step="best")`` against the evaluator's softmax, and a
   ``CheckpointFollower`` that swaps in a newer step (one more
   ``train.train`` step) once.  Each kernel launches once a train step,
   an eval batch and a dispatch.
6. A ``kernels`` JSON line (``launches`` from phase 3's serving run,
   ``train_launches`` from phase 4's ``train``, ``eval_launches`` from
   phase 5's evaluation), then the last line ``{"ok": true, "device":
   {...}}``.

``--profile`` adds a torch.profiler breakdown of a call at each bucket, of
one training step and of a pipelined pass of phase 5's eval loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from attentionalpoolingaction_torch import checkpoint
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import evaluate
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.ops import _build
from attentionalpoolingaction_torch.ops import attn_pool_cuda as apc
from attentionalpoolingaction_torch.train import build_model, normalize_images

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the tensor
# cores (the kernels' FMAs are float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
KERNEL_RTOL = 1e-5      # kernel vs plain, of the largest |output|
# bf16 X: dx is rounded to bf16 (2^-8) after sums taken in another order
BF16_DX_RTOL = 1e-2
CPU_RTOL = 5e-4         # card vs CPU logits through ResNet-101, no TF32
# One train step, card vs CPU, TF32 off.  Float32 rounding grows with depth
# through train-mode batch norm and moves ReLU inputs near zero across the
# kink, so two correct float32 steps differ well beyond float32's epsilon
# in the gradients.  ``python -m attentionalpoolingaction_torch.precision``
# measures a float32 step against a float64 one; at full width, seeds 0-2,
# on an H100 and on its host's CPU, the largest gaps were: grad_norm
# 9.8e-4, each BN statistic's change 3.3e-4 of its largest change, the
# momentum buffers (the clipped gradient plus the decay: the first update
# over -lr) 7.7% in L2 in the worst leaf and 6.0% over all leaves, the
# pooling head's 1.2e-3.  Each tolerance is about 3x that reading; the
# loss's is 1e-3.  conv1 carries 99.997% of grad_norm's square, so
# grad_norm and the overall L2 read conv1; the per-leaf limits cover the
# rest.  Parameter changes themselves are not compared: those of BN
# scales near 1 are a few ulps.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_NORM_RTOL = 3e-3
TRAIN_STAT_RTOL = 1e-3
TRAIN_LEAF_L2 = 0.2
TRAIN_TOTAL_L2 = 0.15
TRAIN_HEAD_L2 = 4e-3
# Phase 5: metrics of the card's and the CPU's logits.  The logits agree
# within CPU_RTOL of the largest; a metric moves only where that flips the
# order of two scores.  One swap moves one class's AP from 1/r to
# 1/(r + 1) at most (0.5 at r = 1), over the >= 25 classes that have a
# positive among 40 images: 0.02 of the mAP; accuracy moves by one image
# in 40.
EVAL_MAP_ATOL = 0.02
EVAL_ACC_ATOL = 1 / 40 + 1e-9
# load_predictor's probabilities against the softmax of the evaluator's
# logits, both on the card, TF32 off: two float32 forwards (batch 8 and
# batch 16) that differ in the order of summation; the CPU tests hold the
# same pair to 1e-4.
SERVE_PROB_ATOL = 1e-4
GRAD_NAMES = ("x", "attn_w", "attn_b", "sal_w", "sal_b")
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
    # B: the serving buckets 1/8/32, an eval batch of 16 and phase 5's
    # 3-crop multicrop forward of 48
    cases = [(b, 49, 393, 1, dt) for dt in (torch.float32, torch.bfloat16)
             for b in (1, 8, 16, 32, 48)]
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
        check_backward(timer, a, w_pfc, (b, n, f, c, p, dt), i)
    return rows


def check_backward(timer, a, w_pfc, case, seed):
    """AttentionalPoolFn's gradients (the kernels' forward, then
    fused_pool_backward) against torch autograd through the plain
    forward, on the same inputs and cotangent; the backward's time beside
    the plain autograd's."""
    b, n, f, c, p, dt = case
    g = torch.randn(b, c, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    fn_in = {k: a[k].detach().clone().requires_grad_() for k in GRAD_NAMES}
    logits = apc.attentional_pool_fused(*(fn_in[k] for k in GRAD_NAMES),
                                        w_pfc=w_pfc)
    logits.backward(g)
    plain_in = {k: a[k].detach().clone().requires_grad_()
                for k in GRAD_NAMES}
    pv, ps = apc.saliency_summary_plain(plain_in["x"], plain_in["sal_w"],
                                        plain_in["sal_b"])
    plain_logits = apc.project_logits_plain(
        pv, ps, plain_in["attn_w"].permute(2, 0, 1), plain_in["attn_b"])
    plain_logits.backward(g, retain_graph=True)
    worst = 0.0
    for k in GRAD_NAMES:
        rel, _ = rel_err(fn_in[k].grad.float(), plain_in[k].grad.float())
        tol = BF16_DX_RTOL if k == "x" and dt == torch.bfloat16 \
            else KERNEL_RTOL
        if not rel < tol:
            raise AssertionError(
                f"d{k} of AttentionalPoolFn disagrees with autograd at B{b} "
                f"N{n} C{c} P{p} {dt}: relative error {rel:.2e} >= {tol}")
        worst = max(worst, rel)
    with torch.no_grad():
        v, s = apc.saliency_summary(a["x"], a["sal_w"], a["sal_b"])
    ms = timer(lambda: apc.fused_pool_backward(
        a["x"], w_pfc, a["attn_b"], a["sal_w"], v, s, g))
    leaves = [plain_in[k] for k in GRAD_NAMES]
    plain_ms = timer(lambda: torch.autograd.grad(plain_logits, leaves, g,
                                                 retain_graph=True))
    # reads x, v, s, g, A (P, F, C), attn_b and sal_w once; writes dx (in
    # x's dtype) and the four weight gradients once
    xs = a["x"].element_size()
    nbytes = 2 * b * n * f * xs + 4 * (b * p * f + b * p * n + b * c
                                       + 2 * p * f * c + 2 * c * p
                                       + 2 * f * p + p)
    flops = 4 * b * p * f * c + 8 * b * n * f * p + 4 * b * c * p
    bms, by = bound_ms(nbytes, flops)
    log(f"B{b:<3} N{n:<4} C{c:<4} P{p} {str(dt).removeprefix('torch.'):<9}"
        f"{'backward':<18}{worst:<10.2e}{ms:<9.4f}{plain_ms:<10.4f}"
        f"{'-':<10}{bms:<10.4f}{bms / ms:.1%} (torch ops; plain = autograd "
        f"of the plain forward; bound by {by})")


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


# -- phase 4 -----------------------------------------------------------------

GRAFT = dict(dataset="mpii", backbone="resnet_v1_50", pooling="pose_attention",
             rank=2, image_size=64, batch_size=4, bf16_backbone=False,
             learning_rate=1e-3, grad_clip_norm=10.0, lr_schedule="constant",
             ema_decay=0.999, grad_accum_steps=2)


def train_batch(rng, cfg):
    """A seeded numpy batch: uint8 images, labels and, for pose attention,
    the crop/flip transform, keypoints and visibility."""
    b, size = cfg.batch_size, cfg.image_size
    batch = {"image": rng.integers(0, 256, (b, size, size, 3), np.uint8),
             "label": rng.integers(0, 393, b).astype(np.int32)}
    if cfg.pooling == "pose_attention":
        batch["transform"] = np.stack(
            [rng.uniform(0.8, 1.2, b), rng.uniform(0.8, 1.2, b),
             rng.uniform(0, 8, b), rng.uniform(0, 8, b),
             (np.arange(b) % 2).astype(np.float64)], 1).astype(np.float32)
        batch["keypoints"] = rng.uniform(0, size, (b, 16, 2)).astype(
            np.float32)
        batch["visibility"] = (rng.uniform(size=(b, 16)) > 0.2).astype(
            np.float32)
    return batch


def train_snapshot(state):
    """CPU copies of what a step changes, by name."""
    opt = state.optimizer
    return {
        "stats": {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()
                  if k.endswith(("running_mean", "running_var"))},
        "momentum": {n: opt.state[p]["momentum_buffer"].cpu().clone()
                     for n, p in state.model.named_parameters()
                     if p in opt.state},
        "params": {n: p.detach().cpu().clone()
                   for n, p in state.model.named_parameters()},
        "ema": ({n: t.cpu().clone() for n, t in state.ema_params.items()}
                if state.ema_params is not None else None),
    }


def sync_state(dst, src):
    """Set ``dst`` to ``src``: weights, statistics, momentum, EMA, step."""
    dst.model.load_state_dict(src.model.state_dict())
    named = dict(dst.model.named_parameters())
    for n, p in src.model.named_parameters():
        if p in src.optimizer.state:
            dst.optimizer.state[named[n]]["momentum_buffer"] = \
                src.optimizer.state[p]["momentum_buffer"].to(
                    named[n].device, copy=True)
    if src.ema_params is not None:
        for n, t in src.ema_params.items():
            dst.ema_params[n].copy_(t)
    dst.step = src.step


def l2_rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def compare_step(what, before, card, cpu, card_m, cpu_m):
    """Raise unless one step on the card agrees with the same step on the
    CPU within the TRAIN_* tolerances; return the worst errors."""
    errs = {}
    for k, want in cpu_m.items():
        got = card_m[k]
        tol = TRAIN_NORM_RTOL if k == "grad_norm" else TRAIN_LOSS_RTOL
        errs[k] = abs(got - want) / abs(want)
        if not (np.isfinite(got) and errs[k] < tol):
            raise AssertionError(f"{what}: {k} {got} on the card, {want} on "
                                 f"the CPU (tolerance {tol})")
    errs["bn_stat_change"] = 0.0
    for k, want in cpu["stats"].items():
        d_card, d_cpu = card["stats"][k] - before["stats"][k], \
            want - before["stats"][k]
        err = float((d_card - d_cpu).abs().max() / d_cpu.abs().max())
        errs["bn_stat_change"] = max(errs["bn_stat_change"], err)
        if not err < TRAIN_STAT_RTOL:
            raise AssertionError(f"{what}: the change of {k} differs by "
                                 f"{err:.2e} of its largest")
    sq_err = sq_ref = errs["momentum_leaf_l2"] = errs["head_l2"] = 0.0
    for k, want in cpu["momentum"].items():
        got = card["momentum"][k]
        err = l2_rel(got, want)
        head = k.startswith("head.")
        tol = TRAIN_HEAD_L2 if head else TRAIN_LEAF_L2
        key = "head_l2" if head else "momentum_leaf_l2"
        errs[key] = max(errs[key], err)
        if not err < tol:
            raise AssertionError(f"{what}: momentum of {k} differs by "
                                 f"{err:.2e} in L2 (tolerance {tol})")
        sq_err += float(((got - want) ** 2).sum())
        sq_ref += float((want ** 2).sum())
    errs["momentum_total_l2"] = (sq_err / sq_ref) ** 0.5
    if not errs["momentum_total_l2"] < TRAIN_TOTAL_L2:
        raise AssertionError(f"{what}: momentum buffers differ by "
                             f"{errs['momentum_total_l2']:.2e} in L2")
    for name, tree in (("params", card["params"]), ("ema", card["ema"])):
        if tree is not None and not all(torch.isfinite(t).all()
                                        for t in tree.values()):
            raise AssertionError(f"{what}: non-finite {name} on the card")
    log(f"{what}: card vs CPU, TF32 off: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_training(card):
    """mpii_rank1_224 at full width: card vs CPU, timed steps, and the
    counted main path through train.train."""
    cfg = config_lib.get_config("mpii_rank1_224")
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=49,
        seed=0)
    rng = np.random.default_rng(1)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    card_state, spec = train.create_state(cfg, device="cuda",
                                          variables=variables)
    cpu_state, _ = train.create_state(cfg, device="cpu", variables=variables)
    step = train.make_train_step(spec, cfg)
    log(f"train states ({cfg.backbone} {cfg.image_size}px batch "
        f"{cfg.batch_size}, card and CPU) built in "
        f"{time.monotonic() - t0:.1f} s")
    batch = train_batch(rng, cfg)
    before = train_snapshot(cpu_state)
    _, card_m = step(card_state, train.batch_to_device(batch, "cuda"))
    t0 = time.monotonic()
    _, cpu_m = step(cpu_state, train.batch_to_device(batch, "cpu"))
    log(f"one CPU step took {time.monotonic() - t0:.1f} s "
        f"({torch.get_num_threads()} threads)")
    errs = compare_step(
        "mpii_rank1_224 step", before, train_snapshot(card_state),
        train_snapshot(cpu_state), {k: float(v) for k, v in card_m.items()},
        {k: float(v) for k, v in cpu_m.items()})
    del cpu_state

    # -- step time, cuDNN's default TF32 -------------------------------------
    torch.backends.cudnn.allow_tf32 = True
    dev_batch = train.batch_to_device(train_batch(rng, cfg), "cuda")
    for _ in range(3):
        step(card_state, dev_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(card_state, dev_batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"train step {cfg.backbone} {cfg.image_size}px batch "
        f"{cfg.batch_size}: median {med * 1e3:.3f} ms over 10 steps (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
        f"{cfg.batch_size / med:.1f} images/s, peak {peak_gb:.2f} GB "
        f"(batch on the card, cudnn TF32 on) on {card}")

    # -- the main path, counted: train.train over 8 numpy batches ------------
    run_cfg = dataclasses.replace(cfg, log_every=4)
    batches = [train_batch(rng, cfg) for _ in range(8)]
    apc.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = train.train(run_cfg, train_iter=iter(batches),
                                 num_steps=8, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(apc.launch_counts)
    log(f"train.train: 8 steps from the seed-{cfg.seed} init in {wall:.1f} s "
        f"(state built included); history {history}; launches {launches}")
    if launches != {"saliency_summary": 8, "project_logits": 8}:
        raise AssertionError(f"kernel launches {launches} over 8 train "
                             "steps, want 8 and 8")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite metrics {history}")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("non-finite parameters after train.train")
    return {"launches": launches, "step_ms": med * 1e3,
            "images_per_s": cfg.batch_size / med, "errs": errs,
            "state": card_state, "step": step, "batch": dev_batch}


def phase_training_small():
    """The __graft_entry__ config without its mesh: 2 steps card vs CPU,
    each from the same state; each kernel launches twice a step."""
    cfg = config_lib.TrainConfig(**GRAFT)
    variables = convert.random_flax_variables(
        cfg.backbone, num_classes=393, rank=cfg.rank, num_positions=4,
        pooling=cfg.pooling, seed=2)
    rng = np.random.default_rng(2)
    torch.backends.cudnn.allow_tf32 = False
    card_state, spec = train.create_state(cfg, device="cuda",
                                          variables=variables)
    cpu_state, _ = train.create_state(cfg, device="cpu", variables=variables)
    step = train.make_train_step(spec, cfg)
    for i in range(2):
        batch = train_batch(rng, cfg)
        sync_state(card_state, cpu_state)
        before = train_snapshot(cpu_state)
        apc.reset_launch_counts()
        _, card_m = step(card_state, train.batch_to_device(batch, "cuda"))
        torch.cuda.synchronize()
        launches = dict(apc.launch_counts)
        if launches != {"saliency_summary": 2, "project_logits": 2}:
            raise AssertionError(f"graft step {i + 1}: launches {launches}, "
                                 "want 2 and 2 (two microbatches)")
        _, cpu_m = step(cpu_state, train.batch_to_device(batch, "cpu"))
        compare_step(f"graft config step {i + 1}", before,
                     train_snapshot(card_state), train_snapshot(cpu_state),
                     {k: float(v) for k, v in card_m.items()},
                     {k: float(v) for k, v in cpu_m.items()})
    torch.backends.cudnn.allow_tf32 = True


def phase_train_profile(run):
    """Device time of one mpii_rank1_224 train step: the top kernels, the
    backward (autograd's nodes), the optimizer, the pooling head's forward
    kernels and backward, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, step, batch = run["state"], run["step"], run["batch"]
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # the device's own events; a record_function range (the optimizer's
    # "Optimizer.step#SGD.step") shows on the device's track too, and
    # would count its kernels twice
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if total == 0:
        raise AssertionError("the profiler saw no device time")

    def inclusive(pred):
        return sum(e.device_time_total for e in averages
                   if e.device_type != DeviceType.CUDA and pred(e.key)) / 1e3

    backward = inclusive(
        lambda k: k.startswith("autograd::engine::evaluate_function"))
    head_bwd = inclusive(lambda k: k.startswith(
        "autograd::engine::evaluate_function") and "AttentionalPoolFn" in k)
    optimizer = inclusive(lambda k: k.startswith("Optimizer.step"))
    head_fwd = sum(e.self_device_time_total for e in kernels
                   if "saliency_summary_kernel" in e.key
                   or "project_logits_kernel" in e.key) / 1e3
    bn = sum(e.self_device_time_total for e in kernels
             if "batch_norm" in e.key) / 1e3
    log(f"profile: one train step, {wall_ms:.3f} ms wall, {total:.3f} ms "
        f"device time (device busy {total / wall_ms:.1%}), "
        f"{sum(e.count for e in kernels)} device events")
    log(f"  backward (autograd nodes) {backward:.3f} ms "
        f"({backward / total:.1%}); optimizer.step {optimizer:.3f} ms; "
        f"the rest (forward, losses, clip, EMA) "
        f"{total - backward - optimizer:.3f} ms; BN kernels (forward and "
        f"backward) {bn:.3f} ms ({bn / total:.1%})")
    log(f"  pooling head: forward kernels {head_fwd:.3f} ms, backward "
        f"(AttentionalPoolFn) {head_bwd:.3f} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms / total:6.1%} {ms:8.3f} ms  {e.count:4d}x  {e.key[:80]}")


# -- phase 5 -----------------------------------------------------------------

def eval_set(rng, n=40, batch=16, crops=0):
    """A seeded uint8 MPII eval set in batches of ``batch``; the last
    batch is padded with rows of mask 0."""
    shape = (n, crops, 224, 224, 3) if crops else (n, 224, 224, 3)
    images = rng.integers(0, 256, shape, np.uint8)
    labels = rng.integers(0, 393, n).astype(np.int32)
    out = []
    for lo in range(0, n, batch):
        b = {"image": images[lo:lo + batch], "label": labels[lo:lo + batch],
             "mask": np.ones(min(batch, n - lo), np.float32)}
        pad = batch - len(b["label"])
        if pad:
            b = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                v.dtype)])
                 for k, v in b.items()}
        out.append(b)
    return out


def state_tensors(state):
    """Every tensor a TrainState holds, by name, and its step."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    named = dict(state.model.named_parameters())
    for n, p in named.items():
        if p in state.optimizer.state:
            out[f"momentum.{n}"] = state.optimizer.state[p]["momentum_buffer"]
    return out, state.step


def counted(fn):
    """``fn()``'s result and the kernel launches it made (counts set to 0
    just before, read after a synchronize)."""
    apc.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, dict(apc.launch_counts)


def expect_launches(what, launches, n):
    if launches != {"saliency_summary": n, "project_logits": n}:
        raise AssertionError(f"{what}: kernel launches {launches}, want {n} "
                             "of each")


def eval_serialized(step_fn, batches):
    """The eval loop without its pipeline: each batch's logits are
    fetched, by a blocking copy, before the next batch is dispatched."""
    return [step_fn(train.batch_to_device({"image": b["image"]}, "cuda")
                    ["image"]).to(torch.float32).cpu().numpy()
            for b in batches]


def eval_rate(step_fn, batches, pipelined, reps):
    """Images/s of ``eval_logits`` (pipelined) or of ``eval_serialized``
    over ``reps`` passes of ``batches``, counting the unpadded images."""
    images = reps * sum(int(b["mask"].sum()) for b in batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if pipelined:
        evaluate.eval_logits(step_fn, batches * reps, device="cuda")
    else:
        eval_serialized(step_fn, batches * reps)
    return images / (time.perf_counter() - t0)


def profile_eval(step_fn, batches):
    """Device time of one pipelined pass of ``batches`` through the eval
    loop, and the device's busy share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate.eval_logits(step_fn, batches, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    if total == 0:
        raise AssertionError("the profiler saw no device time")
    log(f"profile: eval loop, {len(batches)} batches of 16 pipelined, "
        f"{wall_ms:.3f} ms wall, {total:.3f} ms device time (device busy "
        f"{total / wall_ms:.1%}), {sum(e.count for e in events)} device "
        f"events")


def check_eval_against_cpu(what, err, results, cpu_results):
    """The card's eval against the CPU's on the same weights and images:
    logits within CPU_RTOL, 40 examples, metrics within their tolerance."""
    if not err < CPU_RTOL:
        raise AssertionError(f"{what} logits, card vs CPU: {err:.2e}")
    if results["num_examples"] != 40 or cpu_results["num_examples"] != 40:
        raise AssertionError(f"{what}: num_examples is not 40")
    for k, tol in (("mAP", EVAL_MAP_ATOL), ("accuracy", EVAL_ACC_ATOL)):
        if not abs(results[k] - cpu_results[k]) <= tol:
            raise AssertionError(f"{what} {k}: card {results[k]} vs CPU "
                                 f"{cpu_results[k]} (tolerance {tol})")


def phase_checkpointed_run(card, profile=False):
    """mpii_rank1_224 at full width: stop by SIGTERM, resume, evaluate
    (card vs CPU), keep the best, serve it and follow a newer step."""
    t_phase = time.monotonic()
    cfg = config_lib.get_config("mpii_rank1_224")
    rng = np.random.default_rng(5)
    out = {"config": "mpii_rank1_224", "card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        # the seeded Flax-layout weights as step 0 of a port run, from
        # which the run warm-starts (heads fresh, from cfg.seed)
        init, _ = train.create_state(
            cfg, device="cuda", variables=convert.random_flax_variables(
                cfg.backbone, num_classes=393, rank=cfg.rank,
                num_positions=49, seed=0))
        checkpoint.save(checkpoint.make_manager(f"{workdir}/init"), init)
        del init
        run_cfg = dataclasses.replace(
            cfg, workdir=workdir, init_checkpoint=f"{workdir}/init",
            checkpoint_every=2, max_checkpoints=2, log_every=1,
            eval_batch_size=16)
        mgr = checkpoint.make_manager(f"{workdir}/checkpoints",
                                      max_to_keep=2)
        batches = [train_batch(rng, cfg) for _ in range(7)]

        # -- stop by SIGTERM at step 3, then resume to 6 --------------------
        def terminate_at_3(step, state, metrics):
            if step == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        (live, hist1), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches), num_steps=6, device="cuda",
            checkpoint_manager=mgr, hooks=[terminate_at_3]))
        if live.step != 3 or mgr.all_steps() != [2, 3]:
            raise AssertionError(f"SIGTERM at step 3: stopped at "
                                 f"{live.step}, steps {mgr.all_steps()}")
        expect_launches("train.train to the SIGTERM", launches, 3)
        fresh, _ = train.create_state(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.restore(mgr, fresh, step=3)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        want, want_step = state_tensors(live)
        got, got_step = state_tensors(fresh)
        if got.keys() != want.keys() or got_step != want_step or not all(
                torch.equal(got[k], want[k]) for k in want):
            bad = [k for k in want if k not in got
                   or not torch.equal(got[k], want[k])]
            raise AssertionError(f"restored step 3 differs from the live "
                                 f"state: step {got_step}, {bad[:5]}")
        timing = checkpoint.make_manager(f"{workdir}/timing")
        t0 = time.perf_counter()
        checkpoint.save(timing, live)
        out["save_s"] = time.perf_counter() - t0
        out["step_bytes"] = os.path.getsize(
            timing.step_dir(3) / checkpoint.CHECKPOINT_FILE)
        log(f"checkpoint: save {out['save_s']:.3f} s, restore onto the card "
            f"{out['restore_s']:.3f} s, {out['step_bytes']} bytes a step "
            f"({len(want)} tensors, bitwise equal after restore) on {card}")
        del fresh, live, timing

        (state, hist2), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches[3:6]), num_steps=6,
            device="cuda", checkpoint_manager=mgr))
        if state.step != 6 or mgr.all_steps() != [4, 6]:
            raise AssertionError(f"resume: at step {state.step}, steps "
                                 f"{mgr.all_steps()}, want 6 and [4, 6]")
        expect_launches("train.train resumed 3 -> 6", launches, 3)
        history = hist1 + hist2
        if [h["step"] for h in history] != list(range(1, 7)) or not all(
                np.isfinite(v) for h in history for v in h.values()):
            raise AssertionError(f"train history {history}")
        log("train: SIGTERM at 3, resumed to 6, losses " + ", ".join(
            f"{h['loss/total']:.4f}" for h in history))

        # -- evaluate step 6, card vs CPU -------------------------------------
        torch.backends.cudnn.allow_tf32 = False
        restored = checkpoint.restore_for_eval(mgr, 6)
        ev_set = eval_set(rng)
        evaluator = evaluate.Evaluator(run_cfg, device="cuda")
        results, launches = counted(
            lambda: evaluator(restored, eval_iter=iter(ev_set)))
        expect_launches("evaluate (3 batches)", launches, len(ev_set))
        out["eval_launches"] = launches
        card_host = evaluator.logits(restored, iter(ev_set))
        cpu_host = evaluate.Evaluator(run_cfg, device="cpu").logits(
            restored, iter(ev_set))
        real = card_host["mask"].astype(bool)
        err = float(np.abs(card_host["logits"] - cpu_host["logits"])[real]
                    .max() / np.abs(cpu_host["logits"][real]).max())
        cpu_results = evaluate.compute_metrics(run_cfg, cpu_host)
        out.update(eval=results, eval_cpu=cpu_results, eval_logits_err=err)
        log(f"evaluate step 6 (40 images, batches of 16): card {results}; "
            f"CPU {cpu_results}; logits relative error {err:.2e} (tolerance "
            f"{CPU_RTOL:g}, TF32 off)")
        check_eval_against_cpu("evaluate", err, results, cpu_results)

        # -- 3-crop multicrop, card vs CPU (TF32 off) -------------------------
        # 48 crops a forward: the kernels at B=48 (phase 2 holds them
        # against their plain versions there too)
        mc_cfg = dataclasses.replace(run_cfg, eval_multicrop=3)
        mc_set = eval_set(rng, crops=3)
        mc_eval = evaluate.Evaluator(mc_cfg, device="cuda")
        mc_eval.logits(restored, iter(mc_set))                 # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mc_host, launches = counted(
            lambda: mc_eval.logits(restored, iter(mc_set)))
        mc_s = time.perf_counter() - t0
        expect_launches("3-crop multicrop eval (3 batches)", launches,
                        len(mc_set))
        mc_cpu = evaluate.Evaluator(mc_cfg, device="cpu").logits(
            restored, iter(mc_set))
        real = mc_host["mask"].astype(bool)
        mc_err = float(np.abs(mc_host["logits"] - mc_cpu["logits"])[real]
                       .max() / np.abs(mc_cpu["logits"][real]).max())
        mc_results = evaluate.compute_metrics(mc_cfg, mc_host)
        mc_cpu_results = evaluate.compute_metrics(mc_cfg, mc_cpu)
        out["multicrop3"] = dict(mc_results, images_per_s=40 / mc_s,
                                 logits_err=mc_err)
        log(f"3-crop multicrop eval (batches of 16 images, 48 crops a "
            f"forward): card {mc_results}; CPU {mc_cpu_results}; logits "
            f"relative error {mc_err:.2e} (tolerance {CPU_RTOL:g}, TF32 "
            f"off); {40 / mc_s:.1f} images/s ({120 / mc_s:.1f} crops/s, "
            f"TF32 off)")
        check_eval_against_cpu("multicrop", mc_err, mc_results,
                               mc_cpu_results)
        del mc_eval

        # -- the eval loop's rate, pipelined and serialized (TF32 on) --------
        torch.backends.cudnn.allow_tf32 = True
        reps = 5
        eval_rate(evaluator.step_fn, ev_set, True, 1)          # warm
        rates = {True: [], False: []}
        for order in ((True, False), (False, True)) * 3:
            for pipelined in order:
                rates[pipelined].append(
                    eval_rate(evaluator.step_fn, ev_set, pipelined, reps))
        piped, serial = (float(np.median(rates[k])) for k in (True, False))
        out.update(eval_images_per_s_pipelined=piped,
                   eval_images_per_s_serialized=serial,
                   eval_pipeline_ratio=piped / serial)
        log(f"eval loop, {reps} passes of the 40 images (15 batches of 16) "
            f"a timing, 6 timings each, in turns: pipelined {piped:.1f} "
            f"images/s (runs {', '.join(f'{r:.1f}' for r in rates[True])}), "
            f"serialized {serial:.1f} (runs "
            f"{', '.join(f'{r:.1f}' for r in rates[False])}), ratio "
            f"{piped / serial:.3f} (cudnn TF32 on) on {card}")
        if profile:
            profile_eval(evaluator.step_fn, ev_set * reps)

        # -- keep-best, serve it, follow a newer step (TF32 off) -------------
        torch.backends.cudnn.allow_tf32 = False
        keeper = checkpoint.BestKeeper(workdir)
        lower = dict(results, mAP=results["mAP"] - 0.1)
        if not keeper.update(6, results, state) or \
                keeper.update(7, lower, state) or \
                keeper.best()["step"] != 6:
            raise AssertionError(f"BestKeeper: best {keeper.best()}")
        pred = serving.load_predictor(run_cfg, step="best", buckets=(8,),
                                      device="cuda")
        if pred.step != keeper.best()["step"]:
            raise AssertionError(f"load_predictor(step='best') serves step "
                                 f"{pred.step}")
        images = np.concatenate([b["image"] for b in ev_set])[:8]
        probs, launches = counted(lambda: pred.predict_arrays(images))
        expect_launches("load_predictor dispatch", launches, 1)
        logits = card_host["logits"][:8].astype(np.float64)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        perr = float(np.abs(probs - e / e.sum(-1, keepdims=True)).max())
        log(f"load_predictor(step='best') serves step {pred.step}; "
            f"probabilities vs the evaluator's softmax, 8 images: max abs "
            f"difference {perr:.2e} (tolerance {SERVE_PROB_ATOL:g})")
        if not perr < SERVE_PROB_ATOL:
            raise AssertionError(f"served probabilities differ by {perr}")

        follower = serving.CheckpointFollower(pred, mgr)
        if follower.poll_once():
            raise AssertionError("the follower swapped with no newer step")
        (state, _), launches = counted(lambda: train.train(
            run_cfg, train_iter=iter(batches[6:]), num_steps=7,
            device="cuda", checkpoint_manager=mgr))
        expect_launches("train.train resumed 6 -> 7", launches, 1)
        swapped, again = follower.poll_once(), follower.poll_once()
        if not swapped or again or pred.step != 7:
            raise AssertionError(f"follower: swapped {swapped}, again "
                                 f"{again}, serving step {pred.step}")
        probs7 = pred.predict_arrays(images)
        if not (np.isfinite(probs7).all() and np.allclose(
                probs7.sum(-1), 1.0, atol=1e-4)):
            raise AssertionError("bad probabilities after the swap")
        log(f"CheckpointFollower: swapped to step {pred.step} once, not on "
            f"the second poll")
        torch.backends.cudnn.allow_tf32 = True
        del pred, evaluator, state
    out["phase_s"] = time.monotonic() - t_phase
    log(f"phase 5 took {out['phase_s']:.1f} s (workdir removed)")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a profiler breakdown of a call at "
                        "each bucket, of one train step and of the eval "
                        "loop")
    args = parser.parse_args()

    card = phase_device()
    timer = ColdTimer()
    rows = phase_kernels(timer)
    pred, launches = phase_serving(card)
    if args.profile:
        phase_profile(pred)
    del pred
    run = phase_training(card)
    phase_training_small()
    if args.profile:
        phase_train_profile(run)
    del run["state"], run["batch"]
    ckpt_run = phase_checkpointed_run(card, profile=args.profile)

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
            "bound_share": main_row["bound_share"],
            "train_launches": run["launches"][name],
            "eval_launches": ckpt_run["eval_launches"][name]})
    log(json.dumps({"training": {
        "config": "mpii_rank1_224", "card": card,
        "step_ms": run["step_ms"], "images_per_s": run["images_per_s"],
        "card_vs_cpu": run["errs"], "launches": run["launches"]}}))
    log(json.dumps({"checkpointed_run": {
        k: v for k, v in ckpt_run.items() if k != "eval_launches"}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
