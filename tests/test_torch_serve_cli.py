"""The port's HTTP server (``serve_cli.make_server``) and ``predict_cli`` on
a CPU predictor: the JAX package's HTTP tests of ``tests/test_serving.py``
mirrored (end to end, keep-alive, 429 with ``Retry-After``, atomic
``/predict_batch`` with no device work, idle reaping, the connection cap,
a mid-body stall, an over-cap 503 to a client that already sent,
``/predict_video``), serving from an exported artifact
(``--exported_dir``), and the repairs: the over-cap drain ends within its
deadline, a mid-body stall counts as an idle timeout, and decodes run on
at most ``decode_threads`` threads however many connections come and go.

resnet_v1_50 at 64 px (``resize_min`` 72), random Flax-layout weights from
``convert.random_flax_variables``; this file imports no JAX."""

import base64
import http.client
import json
import shutil
import socket
import sys
import tempfile
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import convert
from attentionalpoolingaction_torch import export_cli
from attentionalpoolingaction_torch import predict_cli
from attentionalpoolingaction_torch import serve_cli
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch import train

torch.set_num_threads(2)
SMALL = dict(backbone="resnet_v1_50", image_size=64, resize_min=72)


def tiny_cfg(**kw):
    return config_lib.get_config("mpii_rank1_224", **SMALL, **kw)


@pytest.fixture(scope="module")
def predictor():
    params, stats = convert.random_flax_variables(
        "resnet_v1_50", num_classes=393, num_positions=4)
    return serving.Predictor(tiny_cfg(), params, stats, buckets=(1, 4),
                             device="cpu")


def jpeg(seed=0, size=80) -> bytes:
    img = np.random.default_rng(seed).integers(0, 255, (size, size, 3),
                                               np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    assert ok
    return bytes(buf.tobytes())


class Serving:
    """A started server, stopped (batcher and decode pool too) on exit."""

    def __init__(self, predictor, **kw):
        kw = {"topk": 3, "max_batch": 4, "max_wait_ms": 2.0, **kw}
        self.server = serve_cli.make_server(predictor, "127.0.0.1", 0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        serve_cli.stop_server(self.server)
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()

    def conn(self, timeout=30):
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=timeout)

    def sock(self):
        return socket.create_connection(("127.0.0.1", self.port), timeout=10)


def read_response(sock) -> bytes:
    """Exactly one HTTP response (headers + Content-Length body)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            return data
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    length = 0
    for line in head.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":", 1)[1])
    while len(rest) < length:
        chunk = sock.recv(4096)
        if not chunk:
            break
        rest += chunk
    return head + b"\r\n\r\n" + rest


def same_topk(got: dict, want: dict) -> None:
    """Top-k classes equal, probabilities within 1e-5 (a request may share
    a dispatch, and so a bucket, with others: float32 in another order)."""
    assert [e["class"] for e in got["topk"]] == \
        [e["class"] for e in want["topk"]]
    np.testing.assert_allclose([e["prob"] for e in got["topk"]],
                               [e["prob"] for e in want["topk"]], rtol=1e-5)


def metrics(conn) -> dict:
    conn.request("GET", "/metrics")
    resp = conn.getresponse()
    assert resp.status == 200
    return dict(line.split() for line in resp.read().decode().splitlines()
                if line and not line.startswith("#"))


def test_http_server_end_to_end(predictor):
    want = predictor.predict_bytes([jpeg(2), jpeg(3), jpeg(4)], topk=3)
    before = predictor.stats.snapshot()     # the predictor is shared
    with Serving(predictor) as srv:
        conn = srv.conn()
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["dataset"] == "mpii"
        assert health["int8"] is False and health["buckets"] == [1, 4]

        conn.request("POST", "/predict", body=jpeg(2),
                     headers={"Content-Type": "image/jpeg"})
        out = json.loads(conn.getresponse().read())
        assert len(out["topk"]) == 3
        same_topk(out, want[0])

        payload = json.dumps({"images": [
            base64.b64encode(jpeg(3)).decode(),
            base64.b64encode(b"corrupt").decode(),
            base64.b64encode(jpeg(4)).decode()]})
        conn.request("POST", "/predict_batch", body=payload)
        out = json.loads(conn.getresponse().read())["results"]
        assert len(out) == 3 and out[1]["error"].startswith("bad image: ")
        same_topk(out[0], want[1])
        same_topk(out[2], want[2])

        conn.request("POST", "/predict", body=b"not an image")
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in json.loads(resp.read())

        raw = metrics(conn)
        delta = {k: float(v) - before.get(k, 0.0) for k, v in raw.items()}
        assert delta["serving_requests_total"] == 3
        assert delta["serving_request_errors_total"] == 2
        assert delta["serving_items_total"] == 3
        assert delta["serving_device_seconds_sum"] > 0
        assert float(raw["serving_latency_seconds_count"]) >= 3
        assert 'serving_latency_seconds_bucket{le="+Inf"}' in raw

        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["data_parallel"] is False
        assert health["latency_seconds"]["99"] > 0
        conn.request("GET", "/nowhere")
        assert conn.getresponse().status == 404


def test_http_keepalive_reuses_connection(predictor):
    with Serving(predictor, topk=1) as srv:
        conn = srv.conn()
        conn.request("POST", "/predict", body=jpeg(11))
        resp = conn.getresponse()
        assert resp.version == 11 and not resp.will_close
        resp.read()
        sock = conn.sock
        for method, path, body in [("POST", "/predict", jpeg(12)),
                                   ("POST", "/predict", b"not an image"),
                                   ("GET", "/healthz", None),
                                   ("GET", "/metrics", None)]:
            conn.request(method, path, body=body)
            resp = conn.getresponse()
            assert not resp.will_close
            resp.read()
            assert conn.sock is sock


def test_transfer_encoding_gets_411(predictor):
    with Serving(predictor) as srv:
        s = srv.sock()
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n0\r\n\r\n")
        assert read_response(s).startswith(b"HTTP/1.1 411")
        s.close()


class SlowPredictor:
    """Answers only after ``release``; tags each image by its length."""

    def __init__(self):
        self.stats = serving.ServingStats()
        self.cfg = tiny_cfg()
        self.int8 = False
        self.buckets = (1,)
        self.release = threading.Event()
        self.dispatched = []

    def preprocess(self, image_bytes):
        return np.full((2, 2, 3), len(image_bytes) % 251, np.uint8)

    def predict_preprocessed(self, images, topk=5):
        self.release.wait(timeout=10)
        self.dispatched.extend(int(i[0, 0, 0]) for i in images)
        return [{"topk": []} for _ in images]


def test_http_overload_returns_429_with_retry_after():
    slow = SlowPredictor()
    statuses, lat = [], []
    with Serving(slow, topk=1, max_batch=1, max_wait_ms=1.0,
                 max_queue=1) as srv:
        def fire():
            conn = srv.conn()
            t0 = time.monotonic()
            conn.request("POST", "/predict", body=jpeg(0))
            r = conn.getresponse()
            r.read()
            statuses.append((r.status, r.getheader("Retry-After")))
            lat.append(time.monotonic() - t0)
            conn.close()

        try:
            threads = [threading.Thread(target=fire) for _ in range(6)]
            for th in threads:
                th.start()
                time.sleep(0.05)
            time.sleep(0.3)
            rejected = [s for s in statuses if s[0] == 429]
            assert rejected, statuses
            assert all(ra is not None and int(ra) >= 1 for _, ra in rejected)
            assert max(lat) < 5.0
        finally:
            slow.release.set()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        raw = metrics(srv.conn())
        assert float(raw["serving_rejected_total"]) >= 1
        assert "serving_queue_depth" in raw


def test_http_batch_overload_atomic_no_device_work():
    slow = SlowPredictor()
    with Serving(slow, topk=1, max_batch=1, max_wait_ms=1.0,
                 max_queue=2) as srv:
        def fire_single(blob):
            conn = srv.conn()
            conn.request("POST", "/predict", body=blob)
            conn.getresponse().read()
            conn.close()

        occupiers = []
        try:
            for i in range(3):        # the worker busy, the queue full
                th = threading.Thread(target=fire_single,
                                      args=(b"x" * (10 + i),))
                th.start()
                occupiers.append(th)
                time.sleep(0.15)
            payload = json.dumps({"images": [
                base64.b64encode(b"y" * n).decode() for n in (50, 60)]})
            conn = srv.conn()
            conn.request("POST", "/predict_batch", body=payload)
            r = conn.getresponse()
            body = r.read()
            assert r.status == 429, (r.status, body)
            assert int(r.getheader("Retry-After")) >= 1
        finally:
            slow.release.set()
        for th in occupiers:
            th.join(timeout=30)
        time.sleep(0.3)
        assert 50 not in slow.dispatched and 60 not in slow.dispatched
        assert len(slow.dispatched) == 3


def test_idle_keepalive_connections_are_reaped(predictor):
    socks = []
    with Serving(predictor, topk=1, idle_timeout=0.5) as srv:
        try:
            for _ in range(4):
                s = srv.sock()
                s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
                assert b"200" in read_response(s)
                socks.append(s)
            deadline = time.monotonic() + 10
            while (predictor.stats.gauges()["serving_open_connections"] > 0
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            assert predictor.stats.gauges()["serving_open_connections"] == 0
            for s in socks:
                s.settimeout(5)
                while s.recv(4096) != b"":
                    pass
        finally:
            for s in socks:
                s.close()


def test_connection_cap_rejects_with_503(predictor):
    socks = []
    with Serving(predictor, topk=1, idle_timeout=30.0,
                 max_connections=2) as srv:
        try:
            for _ in range(2):
                s = srv.sock()
                s.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
                assert b"200" in read_response(s)
                socks.append(s)
            s3 = srv.sock()
            socks.append(s3)
            s3.settimeout(10)
            data = read_response(s3)
            assert b"503" in data and b"Connection: close" in data
            assert s3.recv(1024) == b""
            time.sleep(0.2)
            assert predictor.stats.snapshot()[
                "serving_conn_rejected_total"] >= 1
            socks[0].sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            assert b"200" in read_response(socks[0])
        finally:
            for s in socks:
                s.close()


def test_midbody_stall_closes_connection_not_500(predictor):
    """A client stalled mid-body past ``idle_timeout`` is dropped with no
    response, counted as an idle timeout: not as a client disconnect (the
    client did not hang up) and not as an internal error."""
    before = predictor.stats.snapshot()
    with Serving(predictor, topk=1, idle_timeout=0.5) as srv:
        s = srv.sock()
        try:
            s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 1000\r\n\r\n" + b"x" * 10)
            s.settimeout(10)
            assert read_response(s) == b""
        finally:
            s.close()
    snap = predictor.stats.snapshot()

    def delta(k):
        return snap.get(k, 0) - before.get(k, 0)
    assert delta("serving_idle_timeouts_total") == 1
    assert delta("serving_client_disconnects_total") == 0
    assert delta("serving_internal_errors_total") == 0


def test_over_cap_503_reaches_client_that_already_sent(predictor):
    socks = []
    with Serving(predictor, topk=1, idle_timeout=30.0,
                 max_connections=1) as srv:
        try:
            s1 = srv.sock()
            socks.append(s1)
            s1.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            assert b"200" in read_response(s1)
            s2 = srv.sock()
            socks.append(s2)
            s2.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
            s2.settimeout(10)
            data = read_response(s2)
            assert b"503" in data and b"Connection: close" in data
        finally:
            for s in socks:
                s.close()


def test_slow_drip_over_cap_client_is_cut_at_the_drain_deadline(predictor):
    """An over-cap client that drips a byte every 0.1 s holds its handler
    thread no longer than the drain's deadline (the JAX server drained
    until the client stopped sending)."""
    with Serving(predictor, topk=1, idle_timeout=30.0, max_connections=1,
                 drain_seconds=0.5) as srv:
        s1 = srv.sock()
        s1.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        assert b"200" in read_response(s1)
        s2 = srv.sock()
        t0 = time.monotonic()
        cut = None
        try:
            for _ in range(60):
                s2.sendall(b"x")
                time.sleep(0.1)
                if predictor.stats.gauges()["serving_open_connections"] == 1:
                    cut = time.monotonic() - t0
                    break
        except OSError:            # the server reset the connection
            cut = time.monotonic() - t0
        finally:
            s1.close()
            s2.close()
        assert cut is not None and cut < 2.0, cut


def test_decodes_run_on_a_bounded_pool(predictor, monkeypatch):
    """50 short-lived connections decode on at most ``decode_threads``
    threads (on a card, each decoding thread keeps an nvJPEG decoder)."""
    threads = set()
    preprocess = predictor.preprocess

    def recording(data):
        threads.add(threading.get_ident())
        return preprocess(data)

    monkeypatch.setattr(predictor, "preprocess", recording)
    blob = jpeg(21)
    with Serving(predictor, topk=1, decode_threads=2) as srv:
        def client(i):
            conn = srv.conn()
            if i % 2:
                conn.request("POST", "/predict", body=blob)
            else:
                conn.request("POST", "/predict_batch", body=json.dumps(
                    {"images": [base64.b64encode(blob).decode()] * 2}))
            assert conn.getresponse().status == 200
            conn.close()

        for start in range(0, 50, 10):
            batch = [threading.Thread(target=client, args=(i,))
                     for i in range(start, start + 10)]
            for th in batch:
                th.start()
            for th in batch:
                th.join(timeout=60)
                assert not th.is_alive()
    assert 1 <= len(threads) <= 2


def test_http_predict_video(predictor, monkeypatch):
    with Serving(predictor, topk=2) as srv:
        conn = srv.conn(timeout=60)
        body = json.dumps({"frames": [
            base64.b64encode(jpeg(i)).decode() for i in range(4)]})
        conn.request("POST", "/predict_video", body=body)
        r = conn.getresponse()
        out = json.loads(r.read())
        assert r.status == 200, out
        assert len(out["topk"]) == 2 and out["frames_received"] == 4
        same_topk(out, predictor.predict_clip_bytes(
            [jpeg(i) for i in range(4)], topk=2))
        conn.request("POST", "/predict_video", body="{}")
        r = conn.getresponse()
        assert r.status == 400
        json.loads(r.read())
        conn.request("POST", "/predict_video", body=b"not a video",
                     headers={"Content-Type": "video/mp4"})
        r = conn.getresponse()
        assert r.status == 400
        assert "bad video" in json.loads(r.read())["error"]
        # the card's machine has no OpenCV: a video upload is a 400 there
        monkeypatch.setitem(sys.modules, "cv2", None)
        conn.request("POST", "/predict_video", body=b"\x00" * 64,
                     headers={"Content-Type": "video/mp4"})
        r = conn.getresponse()
        err = json.loads(r.read())["error"]
        assert r.status == 400 and err.startswith("bad video: ")
        assert "OpenCV" in err


@pytest.fixture(scope="module")
def workdir():
    with tempfile.TemporaryDirectory() as d:
        cfg = tiny_cfg(workdir=d, batch_size=2)
        state, _ = train.create_state(cfg, device="cpu")
        ckpt_lib.save(ckpt_lib.make_manager(d + "/checkpoints"), state)
        yield d


def test_predict_cli_prints_one_line_an_image(workdir, tmp_path, capsys):
    paths = []
    for i in range(3):
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(jpeg(30 + i))
        paths.append(str(p))
    sets = [f"--set={k}={v!r}" for k, v in SMALL.items()]
    # batch 1, as /predict dispatches one request alone: the same bits
    predict_cli.main(["--workdir", workdir, "--images", *paths, "--topk",
                      "2", "--batch_size", "1", "--device", "cpu", *sets])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["image"] for x in lines] == paths
    pred = serving.load_predictor(tiny_cfg(workdir=workdir), buckets=(1,),
                                  device="cpu")
    with Serving(pred, topk=2) as srv:
        conn = srv.conn()
        for path, line in zip(paths, lines):
            with open(path, "rb") as f:
                conn.request("POST", "/predict", body=f.read())
            assert json.loads(conn.getresponse().read())["topk"] == \
                line["topk"]
    predict_cli.main(["--workdir", workdir, "--images", *paths, "--int8",
                      "--device", "cpu", *sets])
    int8_lines = capsys.readouterr().out.strip().splitlines()
    assert len(int8_lines) == 3
    assert all(len(json.loads(x)["topk"]) == 5 for x in int8_lines)
    predict_cli.main(["--workdir", workdir, "--video", "--images", *paths,
                      "--device", "cpu", *sets])
    clip = json.loads(capsys.readouterr().out.strip())
    assert clip["frames"] == paths and clip["frames_received"] == 3
    # --data_parallel on a host of one device: single-device dispatch,
    # the same answers (JAX's rule)
    predict_cli.main(["--workdir", workdir, "--images", *paths, "--topk",
                      "2", "--batch_size", "1", "--data_parallel",
                      "--device", "cpu", *sets])
    assert [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()] == lines
    served = serve_cli.load_served(serve_cli.parse_args(
        ["--workdir", workdir, "--data_parallel", "--device", "cpu", *sets]))
    assert served.replicas == () and served.buckets == (1, 8, 32)
    # the same checkpoint exported: predict_cli and serve_cli answer from
    # the artifact with the checkpoint's bits (float32 on the CPU)
    art = str(tmp_path / "artifact")
    export_cli.main(["--workdir", workdir, "--out_dir", art, "--buckets",
                     "1", "--input_dtypes", "uint8", "--device", "cpu",
                     *sets])
    capsys.readouterr()
    predict_cli.main(["--exported_dir", art, "--images", *paths, "--topk",
                      "2", "--batch_size", "1", "--device", "cpu"])
    assert [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()] == lines
    served = serve_cli.load_served(serve_cli.parse_args(
        ["--exported_dir", art, "--device", "cpu"]))
    assert served.buckets == (1,) and not served.int8
    with Serving(served, topk=2) as srv:
        conn = srv.conn()
        for path, line in zip(paths, lines):
            with open(path, "rb") as f:
                conn.request("POST", "/predict", body=f.read())
            assert json.loads(conn.getresponse().read())["topk"] == \
                line["topk"]
    # what the artifact fixed is a usage error beside it, as is --follow
    for extra, name in ((["--workdir", workdir], "--workdir"),
                        (["--int8"], "--int8"), (["--noema"], "--ema"),
                        (["--config", "mpii_rank1_224"], "--config"),
                        (["--step", "3"], "--step"), (sets[:1], "--set")):
        with pytest.raises(SystemExit, match=name):
            predict_cli.main(["--exported_dir", art, "--images", *paths,
                              *extra])
    for extra in (["--buckets", "1"], ["--calibration_images", paths[0]]):
        with pytest.raises(SystemExit, match=extra[0]):
            serve_cli.main(["--exported_dir", art, *extra])
    with pytest.raises(SystemExit, match="immutable"):
        serve_cli.main(["--exported_dir", art, "--follow"])
    shutil.rmtree(art)      # ~100 MB; pytest keeps its tmp_path
