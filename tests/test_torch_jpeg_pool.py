"""The decode pool of ``data/jpeg.py`` on the CPU, where OpenCV decodes
through the same map as nvJPEG on a card: a call of two or more streams
spreads its images over ``pool_width(n)`` threads of the process's pool
and gives the serial decode's images in input order; a one-stream call
decodes inline on the caller's thread; a failing stream raises the serial
decode's error for the first failing index, once every task is done; the
span ``jpeg.decode`` stays one a call, on the caller's thread, with the
``threads`` it used, more than one for a pooled call.  No JAX here."""

import contextlib
import os
import sys
import threading
import time

import pytest
import torch

from attentionalpoolingaction_torch.data import jpeg
from attentionalpoolingaction_torch.utils import profiling

from kernel_trace import traced

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_torch")
NAMES = ["odd_517x333.jpg", "gray_400x300.jpg", "portrait_480x640.jpg",
         "yuv422_480x360.jpg", "yuv444_720x540.jpg"]


def fixture(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def streams(n):
    """``n`` streams, the fixtures in turn: neighbours differ in size."""
    return [fixture(NAMES[i % len(NAMES)]) for i in range(n)]


def zero_height(data):
    """``data`` with its frame header's height set to 0: the header reads,
    OpenCV's decode fails."""
    i = data.index(b"\xff\xc0")
    return data[:i + 5] + b"\0\0" + data[i + 7:]


@contextlib.contextmanager
def num_threads(n):
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def pooled(trace):
    """Whether each ``jpeg.decode`` call of a trace took the pool."""
    return [s.ids["threads"] > 1 for s in trace.spans("jpeg.decode")]


@pytest.mark.parametrize("n", [1, 2, 7, 8, 17])
def test_a_pooled_batch_is_the_image_by_image_decode(n, monkeypatch):
    datas = streams(n)
    want = [jpeg.decode([d], "cpu")[0] for d in datas]
    seen = recording(monkeypatch)
    with num_threads(4):
        got, trace = traced(lambda: jpeg.decode(datas, "cpu"))
    assert pooled(trace) == [n > 1]
    assert (threading.get_ident() in seen["threads"]) == (n == 1)
    assert len(got) == n
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a, b), i


def recording(monkeypatch, delay=0.0, fail=()):
    """Patch the per-image decode to note its thread, the threads decoding
    at once, and the images finished; images in ``fail`` raise as a
    corrupt stream does."""
    seen = {"threads": [], "busy": 0, "most": 0, "done": []}
    lock = threading.Lock()
    decode_one = jpeg._decode_cpu

    def one(data, index):
        with lock:
            seen["threads"].append(threading.get_ident())
            seen["busy"] += 1
            seen["most"] = max(seen["most"], seen["busy"])
        try:
            if index in fail:
                raise ValueError(f"JPEG {index}: decode failed")
            time.sleep(delay)
            out = decode_one(data, index)
            with lock:
                seen["done"].append(index)
            return out
        finally:
            with lock:
                seen["busy"] -= 1

    monkeypatch.setattr(jpeg, "_decode_cpu", one)
    return seen


def test_a_one_image_call_decodes_on_the_callers_thread(monkeypatch):
    seen = recording(monkeypatch)
    with num_threads(4):
        (img,), trace = traced(lambda: jpeg.decode(streams(1), "cpu"))
    assert seen["threads"] == [threading.get_ident()]
    assert img.shape == (333, 517, 3) and pooled(trace) == [False]
    with num_threads(4):
        _, trace = traced(lambda: jpeg.decode(streams(8), "cpu"))
    on = set(seen["threads"][1:])
    assert threading.get_ident() not in on and 1 <= len(on) <= 4
    assert pooled(trace) == [True]


@pytest.mark.parametrize("torch_threads, n, width", [
    (2, 1, 1), (2, 2, 2), (2, 8, 2), (3, 8, 3), (16, 5, 5), (16, 8, 8),
    (16, 17, 8), (1, 8, 1)])
def test_the_width_is_streams_torch_threads_and_the_cap(torch_threads, n,
                                                        width, monkeypatch):
    """``min(n, torch.get_num_threads(), POOL_THREADS)``: that many images
    decode at once (each holds its thread 100 ms), never more."""
    assert jpeg.POOL_THREADS == 8
    seen = recording(monkeypatch, delay=0.1)
    with num_threads(torch_threads):
        assert jpeg.pool_width(n) == width
        jpeg.decode(streams(n), "cpu")
    assert seen["most"] == width
    assert len(set(seen["threads"])) <= width
    assert sorted(seen["done"]) == list(range(n))


@pytest.mark.parametrize("bad", [(3,), (3, 5)])
def test_a_bad_stream_raises_its_index_after_every_task(bad, monkeypatch):
    """Stream 3 fails at once while the others take 30 ms each: the call
    raises the serial decode's error for image 3 only when every other
    image is decoded, so no task is left writing."""
    datas = streams(8)
    for i in bad:
        datas[i] = zero_height(datas[i])
    with num_threads(4), pytest.raises(ValueError,
                                       match=r"^JPEG 3: decode failed$"):
        jpeg.decode(datas, "cpu")
    seen = recording(monkeypatch, delay=0.03, fail=bad)
    with num_threads(4), pytest.raises(ValueError, match=r"^JPEG 3: "):
        jpeg.decode(streams(8), "cpu")
    assert sorted(seen["done"]) == [i for i in range(8) if i not in bad]
    assert seen["busy"] == 0


def test_a_header_error_raises_before_any_decode(monkeypatch):
    seen = recording(monkeypatch)
    datas = streams(8)
    datas[5] = datas[5][:100]
    with num_threads(4), pytest.raises(ValueError, match="^JPEG 5: "):
        jpeg.decode(datas, "cpu")
    assert seen["threads"] == []


def test_one_span_a_call_with_its_threads_and_the_pooled_count():
    with num_threads(4):
        _, trace = traced(lambda: [jpeg.decode(streams(k), "cpu")
                                   for k in (8, 1, 3)])
    spans = trace.spans("jpeg.decode")
    assert [s.ids for s in spans] == [{"images": 8, "threads": 4},
                                      {"images": 1, "threads": 1},
                                      {"images": 3, "threads": 3}]
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert spans == [s for s in profiling.spans() if s.name == "jpeg.decode"]
    assert pooled(trace).count(True) == 2
    tot = profiling.span_totals()["jpeg.decode"]
    assert (tot["count"], tot["images"], tot["threads"]) == (3, 12, 8)


def test_callers_on_many_threads_share_the_pool():
    """Six callers at once, each decoding batches of 8 through the pool
    with the interpreter switching threads every microsecond: every image
    in its place and every pooled call counted."""
    want = [jpeg.decode([d], "cpu")[0] for d in streams(8)]
    results, errors = [], []

    def caller():
        try:
            for _ in range(5):
                results.append(jpeg.decode(streams(8), "cpu"))
        except Exception as e:      # noted for the assertion below
            errors.append(e)

    def callers():
        threads = [threading.Thread(target=caller) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        return threads

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with num_threads(4):
            threads, trace = traced(callers)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 30 and pooled(trace) == [True] * 30
    for got in results:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
