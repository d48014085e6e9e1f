"""The port's spans (``utils/profiling.py``), on the CPU: the process-wide
flag they read, what they record with and without a profiler, threads the
profiler does not capture, the shared clock with the Chrome trace, parent
links, self time and sessions; then the spans of one ``/predict`` to a CPU
server and of a 3-step ``train.train`` from records.  This file imports no
JAX."""

import dataclasses
import http.client
import json
import os
import tempfile
import threading
import time

import cv2
import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import serve_cli
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train
from attentionalpoolingaction_torch.data import records
from attentionalpoolingaction_torch.data.datasets import get_dataset
from attentionalpoolingaction_torch.utils import profiling

torch.set_num_threads(2)
SMALL = dict(backbone="resnet_v1_50", image_size=64, resize_min=72)


def cpu_profile():
    """A profiler of the host, as another caller starts one; the span
    before it, which runs with no profiler, makes it a new session."""
    with profiling.span("between.sessions"):
        pass
    return profile(activities=[ProfilerActivity.CPU])


def on_thread(fn):
    """``fn()``'s result, run on a new thread."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    return out[0]


def test_the_flag_is_process_wide_on_the_installed_torch():
    """Spans read ``_is_profiler_enabled``, a module global that every
    thread sees; the profiler's own test is per thread (only the thread
    that started it is captured)."""
    assert hasattr(autograd_profiler, "_is_profiler_enabled")
    assert profiling.profiler_running() is False
    with cpu_profile():
        assert profiling.profiler_running() is True
        assert on_thread(profiling.profiler_running) is True
        assert torch._C._autograd._profiler_enabled()
        assert not on_thread(torch._C._autograd._profiler_enabled)
    assert profiling.profiler_running() is False
    assert on_thread(profiling.profiler_running) is False


def test_no_profiler_records_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(profiling, "record_function", entered)
    before = len(profiling.spans())
    with profiling.span("idle", request=1) as s:
        assert s is None and profiling.current() is None
    profiling.record_span("idle.wait", 0, 10)
    assert len(profiling.spans()) == before


def test_spans_from_threads_started_before_and_after_the_profiler():
    go = threading.Event()
    idents = {}

    def work(name):
        go.wait(timeout=30)
        idents[name] = threading.get_ident()
        with profiling.span(name):
            time.sleep(0.002)

    early = threading.Thread(target=work, args=("early",))
    early.start()
    with cpu_profile():
        late = threading.Thread(target=work, args=("late",))
        late.start()
        go.set()
        for th in (early, late):
            th.join(timeout=30)
            assert not th.is_alive()
    got = {s.name: s.thread for s in profiling.spans()}
    assert got == idents and len(set(got.values())) == 2


def test_span_starts_share_the_chrome_trace_clock(tmp_path):
    # the first record_function of a process sets up lazily, after the
    # span has read its start: a session beforehand takes that cost
    with profiling.trace(str(tmp_path / "warm")):
        with profiling.span("warm"):
            pass
    names = [f"clock.{i}" for i in range(8)]
    with profiling.trace(str(tmp_path / "t")):
        for name in names:
            with profiling.span(name):
                torch.ones(256).sum()
                time.sleep(0.001)
    (path,) = os.listdir(tmp_path / "t")
    with open(tmp_path / "t" / path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    marks = {e["name"]: base + 1e3 * e["ts"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    starts = {s.name: s.start_ns for s in profiling.spans()}
    assert sorted(starts) == sorted(names)
    for name in names:
        assert abs(starts[name] - marks[name]) < 1e5, name


def test_parents_self_time_and_the_latest_session(tmp_path):
    with profiling.trace(str(tmp_path / "a")):
        with profiling.span("outer", request=5) as outer:
            with profiling.span("inner", images=3):
                time.sleep(0.004)
            time.sleep(0.004)
            t = time.time_ns()
            # a wait recorded from a thread with no span open
            on_thread(lambda: profiling.record_span(
                "wait", t - 2_000_000, t, parent=outer, images=4))
            with profiling.span("inner", images=2):
                time.sleep(0.004)
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, []).append(s)
    assert [len(by[k]) for k in ("outer", "inner", "wait")] == [1, 2, 1]
    outer = by["outer"][0]
    assert all(s.parent is outer for s in by["inner"] + by["wait"])
    assert outer.parent is None
    assert {s.get("request") for s in by["inner"] + by["wait"]} == {5}
    assert by["wait"][0].thread != outer.thread
    tot = profiling.span_totals()
    assert tot["inner"]["count"] == 2 and tot["inner"]["images"] == 5
    assert tot["wait"]["images"] == 4
    assert tot["wait"]["seconds"] == pytest.approx(2e-3)
    # the children cover the two inner spans and the wait, which lies
    # in the 4 ms between them
    covered = sum(s.end_ns - s.start_ns for s in by["inner"] + by["wait"])
    assert tot["outer"]["self_seconds"] == pytest.approx(
        outer.seconds - covered * 1e-9, abs=1e-9)
    assert tot["outer"]["self_seconds"] >= 0.002
    assert tot["inner"]["self_seconds"] == pytest.approx(
        tot["inner"]["seconds"])
    # a new session of trace() keeps only its own spans
    with profiling.trace(str(tmp_path / "b")):
        with profiling.span("second"):
            pass
    assert [s.name for s in profiling.spans()] == ["second"]
    # so does another profiler's, after a span ran with none (cpu_profile)
    with cpu_profile():
        with profiling.span("third"):
            pass
    assert [s.name for s in profiling.spans()] == ["third"]


def test_overlapping_children_count_once():
    with cpu_profile():
        with profiling.span("root") as root:
            time.sleep(0.005)
            t = time.time_ns()
            # a and b overlap: together 3 ms
            profiling.record_span("a", t - 3_000_000, t - 1_000_000)
            profiling.record_span("b", t - 2_000_000, t)
            # a child reaching outside its parent counts only inside: 1 us
            profiling.record_span("c", root.start_ns - 10_000_000,
                                  root.start_ns + 1_000)
    assert t - 3_000_000 > root.start_ns + 1_000
    tot = profiling.span_totals()["root"]
    assert tot["self_seconds"] == pytest.approx(
        (root.end_ns - root.start_ns - 3_001_000) * 1e-9, abs=1e-9)


def test_one_predict_shares_its_request_id():
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=393, num_positions=4)
    pred = serving.Predictor(
        config_lib.get_config("mpii_rank1_224", **SMALL), params, stats,
        buckets=(1, 4), device="cpu")
    img = np.random.default_rng(3).integers(0, 255, (80, 96, 3), np.uint8)
    body = bytes(cv2.imencode(".jpg", img)[1].tobytes())
    server = serve_cli.make_server(pred, "127.0.0.1", 0, topk=3,
                                   max_batch=4, max_wait_ms=2.0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=60)
        with cpu_profile():
            conn.request("POST", "/predict", body=body)
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["topk"]
        conn.close()
    finally:
        serve_cli.stop_server(server)
        th.join(timeout=5)
    assert not th.is_alive()
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, []).append(s)
    names = ("serve.request", "serve.decode_wait", "serve.preprocess",
             "jpeg.decode", "serve.queue_wait", "serve.batch",
             "serve.dispatch")
    assert {k: len(v) for k, v in by.items()} == dict.fromkeys(names, 1)
    (req,) = by["serve.request"]
    rid = req.ids["request"]
    for name in ("serve.decode_wait", "serve.preprocess", "jpeg.decode",
                 "serve.queue_wait"):
        assert by[name][0].get("request") == rid, name
    assert by["serve.dispatch"][0].get("requests") == [rid]
    assert by["jpeg.decode"][0].ids == {"images": 1, "threads": 1}
    assert by["jpeg.decode"][0].parent is by["serve.preprocess"][0]
    assert by["serve.dispatch"][0].parent is by["serve.batch"][0]
    # the pool's decode and the batcher run on threads of their own
    assert len({req.thread, by["jpeg.decode"][0].thread,
                by["serve.dispatch"][0].thread}) == 3
    wait, pre, queued = (by[k][0] for k in (
        "serve.decode_wait", "serve.preprocess", "serve.queue_wait"))
    assert wait.end_ns <= pre.start_ns <= pre.end_ns <= queued.start_ns
    assert queued.end_ns <= by["serve.dispatch"][0].start_ns
    assert req.start_ns <= wait.start_ns and queued.end_ns <= req.end_ns


def test_train_spans_once_a_step_under_it():
    spec = get_dataset("mpii")
    cfg = config_lib.TrainConfig(
        dataset="mpii", backbone="resnet_v1_50", pooling="attention",
        image_size=64, resize_min=72, resize_max=90, batch_size=2,
        bf16_backbone=False, learning_rate=1e-3, lr_schedule="constant",
        log_every=10)
    with tempfile.TemporaryDirectory() as d:
        records.write_synthetic_dataset(f"{d}/train.tfrecord", spec, 8,
                                        image_size=80)
        cfg = dataclasses.replace(cfg, train_pattern=f"{d}/train.tfrecord")
        with profiling.trace(f"{d}/trace"):
            state, _ = train.train(cfg, num_steps=3, device="cpu")
    assert state.step == 3
    steps = [s for s in profiling.spans() if s.name == "train.step"]
    assert [s.ids["step"] for s in steps] == [1, 2, 3]
    for name in ("train.input", "train.forward", "train.backward",
                 "train.optimizer"):
        under = [s.parent.ids["step"] for s in profiling.spans()
                 if s.name == name]
        assert under == [1, 2, 3], name
        assert all(s.parent.name == "train.step" for s in profiling.spans()
                   if s.name == name)
    decodes = [s for s in profiling.spans() if s.name == "jpeg.decode"]
    assert decodes and all(s.parent.name == "train.input" for s in decodes)
    tot = profiling.span_totals()
    assert tot["jpeg.decode"]["images"] >= 6
    assert tot["train.step"]["self_seconds"] < tot["train.step"]["seconds"]
