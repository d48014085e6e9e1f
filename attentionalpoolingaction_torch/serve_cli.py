"""HTTP model server: the port of the JAX package's ``serve_cli.py``, with
argparse in place of absl and the same flags by name.

    python -m attentionalpoolingaction_torch.serve_cli \\
        --config mpii_rank1_224 --workdir /tmp/run1 --port 8800 \\
        [--int8 [--calibration_images a.jpg ...]] [--step best] \\
        [--follow] [--decode_threads 4] [--device cpu]
    python -m attentionalpoolingaction_torch.serve_cli \\
        --exported_dir /tmp/run1/artifact --port 8800 [--device cpu]

It serves the checkpoint of ``--workdir`` (the latest step, ``--step N``
or ``--step best``), or the artifact of ``--exported_dir``
(``export_cli.py``; no model build, no checkpoint), on ``--device``
(default ``cuda``).  Std-lib only
(``ThreadingHTTPServer``, HTTP/1.1 keep-alive); requests coalesce through
``serving.DynamicBatcher``, so concurrent clients share device dispatches.

Endpoints:
    GET  /healthz          -> {"status": "ok", ..., "latency_seconds":
                              {"50", "95", "99"}}
    GET  /metrics          -> Prometheus text
    POST /predict          body = raw JPEG/PNG bytes -> {"topk": [...]}
    POST /predict_batch    body = {"images": [<base64>, ...]}
                           -> {"results": [{"topk": [...]}, ...]}
    POST /predict_video    body = {"frames": [<base64>, ...]} (ordered),
                           or a video file (Content-Type: video/*; needs
                           OpenCV, else a 400 "bad video")
                           -> one clip-pooled {"topk": [...]}

Request bytes are decoded on a pool of ``--decode_threads`` threads, not
on the connection's handler thread: on a card each decoding thread keeps
an nvJPEG handle and state for the life of the process, so the pool bounds
them however many connections come and go.  The pool's decodes and the
batcher's forwards share the thread-default CUDA stream, so a crop is
ready in stream order before any forward that reads it.

Traced (``utils/profiling.py``), a POST is the span ``serve.request`` with
a ``request`` id; under it, each image's wait for a decoding thread
(``serve.decode_wait``), its decode and crop there (``serve.preprocess``,
holding ``jpeg.decode``) and its wait in the batcher's queue
(``serve.queue_wait``).

Repairs of the JAX server: a connection over ``--max_connections`` is
answered with its 503 and drained for at most ``drain_seconds`` or
``DRAIN_BYTES``, whichever comes first; a client that stalls mid-body is
dropped and counted in ``serving_idle_timeouts_total``, not in
``serving_client_disconnects_total``.

With ``--exported_dir`` the checkpoint-only flags (``--config``,
``--workdir``, ``--int8``, ``--ema``, ``--step``, ``--calibration_images``,
``--set``, ``--buckets``) are usage errors, as is ``--follow``: the
artifact fixed them all.  ``--data_parallel`` serves one replica a local
card where there is more than one (single-device dispatch on a one-card
host, as JAX's rule is; ``serving.py``), and ``/healthz`` says whether
replicas exist; ``--device`` takes the place of ``--jax_platform``.
"""

from __future__ import annotations

import argparse
import base64
import itertools
import json
import logging
import signal
import socket
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from attentionalpoolingaction_torch import checkpoint as ckpt_lib
from attentionalpoolingaction_torch import config as config_lib
from attentionalpoolingaction_torch import serving
from attentionalpoolingaction_torch.train_cli import add_bool_flag
from attentionalpoolingaction_torch.utils import profiling

log = logging.getLogger(__name__)

DRAIN_SECONDS = 2.0
DRAIN_BYTES = 64 * 1024


def make_server(predictor: serving.BucketedPredictor, host: str, port: int,
                topk: int, max_batch: int, max_wait_ms: float,
                max_queue: int | None = 256,
                idle_timeout: float | None = 30.0,
                max_connections: int | None = 128,
                decode_threads: int = 4,
                drain_seconds: float = DRAIN_SECONDS) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server.  ``server.batcher`` and
    ``server.decode_pool`` are its batcher and its pool of decoding
    threads; stop both after ``server.shutdown()``."""
    stats = predictor.stats
    # the batcher coalesces PREPROCESSED crops: decode and resize run on
    # the pool, and a bad image answers 400 before it takes queue room
    batcher = serving.DynamicBatcher(
        lambda imgs: predictor.predict_preprocessed(imgs, topk=topk),
        max_batch=max_batch, max_wait_ms=max_wait_ms, max_queue=max_queue,
        stats=stats)
    pool = ThreadPoolExecutor(max_workers=decode_threads,
                              thread_name_prefix="decode")
    conn_lock = threading.Lock()
    conn_count = [0]
    request_ids = itertools.count()

    def preprocess(body: bytes, parent, t_submit: int):
        profiling.record_span("serve.decode_wait", t_submit, time.time_ns(),
                              parent=parent)
        with profiling.span("serve.preprocess", parent=parent):
            return predictor.preprocess(body)

    def decode(body: bytes):
        """The future of a request image's crop, made on the pool."""
        return pool.submit(preprocess, body, profiling.current(),
                           time.time_ns())

    def drain(sock: socket.socket) -> None:
        """Read what an over-cap client sent, so that our close sends FIN
        and not RST (which would discard the 503 before the client reads
        it), for at most ``drain_seconds`` or ``DRAIN_BYTES``."""
        deadline = time.monotonic() + drain_seconds
        got = 0
        while got < DRAIN_BYTES:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            sock.settimeout(left)
            chunk = sock.recv(min(4096, DRAIN_BYTES - got))
            if not chunk:
                return
            got += len(chunk)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: every response below sends Content-Length
        protocol_version = "HTTP/1.1"
        # one thread a connection for its whole life: a read timeout reaps
        # idle keep-alive clients (handle_one_request closes on it)
        timeout = idle_timeout

        def setup(self):
            super().setup()
            with conn_lock:
                conn_count[0] += 1
                n = conn_count[0]
                stats.set_gauge("serving_open_connections", n)
            self._over_cap = (max_connections is not None
                              and n > max_connections)

        def finish(self):
            try:
                super().finish()
            finally:
                with conn_lock:
                    conn_count[0] -= 1
                    stats.set_gauge("serving_open_connections",
                                    conn_count[0])

        def handle(self):
            if self._over_cap:
                # raw response: the request line was never read
                stats.inc("serving_conn_rejected_total")
                try:
                    self.wfile.write(
                        b"HTTP/1.1 503 Service Unavailable\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n"
                        b"Retry-After: 1\r\n\r\n")
                    self.wfile.flush()
                    self.connection.shutdown(socket.SHUT_WR)
                    drain(self.connection)
                except OSError:
                    pass
                return
            super().handle()

        def log_message(self, fmt, *args):
            log.info("%s " + fmt, self.address_string(), *args)

        def _json(self, code: int, payload: dict, headers: dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                q = stats.latency_quantile
                lat = {p: (None if (v := q(p / 100)) != v else round(v, 6))
                       for p in (50, 95, 99)}   # NaN (no traffic) -> null
                self._json(200, {"status": "ok",
                                 "dataset": predictor.cfg.dataset,
                                 "int8": predictor.int8,
                                 "buckets": list(predictor.buckets),
                                 "data_parallel": bool(predictor.replicas),
                                 "latency_seconds": lat})
            elif self.path == "/metrics":      # Prometheus text format
                body = stats.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "unknown path"})

        def _count(self, results) -> None:
            for r in results:
                stats.inc("serving_requests_total" if "error" not in r
                          else "serving_request_errors_total")

        def do_POST(self):
            with profiling.span("serve.request", request=next(request_ids)):
                self._post()

        def _post(self):
            t_start = time.monotonic()
            observed = False

            def observe_once():
                # each request enters the latency histogram once
                nonlocal observed
                if not observed:
                    observed = True
                    stats.observe_latency(time.monotonic() - t_start)

            if self.headers.get("Transfer-Encoding"):
                # an unread chunked body would corrupt the next request
                self.close_connection = True
                self._json(411, {"error": "send Content-Length, not "
                                          "Transfer-Encoding"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    body = self.rfile.read(n)
                except TimeoutError:
                    # idle_timeout fired mid-body: the stream is out of
                    # step, so drop the connection; the server timed the
                    # client out, the client did not hang up
                    self.close_connection = True
                    stats.inc("serving_idle_timeouts_total")
                    observe_once()
                    return
                if self.path == "/predict":
                    try:
                        img = decode(body).result()
                    except Exception as exc:
                        observe_once()
                        stats.inc("serving_request_errors_total")
                        self._json(400, {"error": f"bad image: {exc}"})
                        return
                    res = batcher.submit(img).result(timeout=60)
                    observe_once()
                    stats.inc("serving_requests_total")
                    self._json(200, res)
                elif self.path == "/predict_video":
                    # one video, one dispatch; decoded on the pool
                    if self.headers.get("Content-Type", "").startswith(
                            "video/"):
                        res = pool.submit(predictor.predict_video_bytes,
                                          body, topk=topk).result()
                    else:
                        try:
                            frames = [base64.b64decode(b)
                                      for b in json.loads(body)["frames"]]
                        except Exception as exc:
                            stats.inc("serving_request_errors_total")
                            self._json(400, {"error": f"bad request: {exc}"})
                            return
                        res = pool.submit(predictor.predict_clip_bytes,
                                          frames, topk=topk).result()
                    observe_once()
                    self._count([res])
                    self._json(200 if "error" not in res else 400, res)
                elif self.path == "/predict_batch":
                    try:
                        blobs = [base64.b64decode(b)
                                 for b in json.loads(body)["images"]]
                    except Exception as exc:
                        stats.inc("serving_request_errors_total")
                        self._json(400, {"error": f"bad request: {exc}"})
                        return
                    # each item decodes on its own: a corrupt one errors
                    # its own slot only and is never enqueued
                    decodes = [decode(b) for b in blobs]
                    results: list = [None] * len(blobs)
                    imgs, slots = [], []
                    for i, fut in enumerate(decodes):
                        try:
                            imgs.append(fut.result())
                            slots.append(i)
                        except Exception as exc:
                            results[i] = {"error": f"bad image: {exc}"}
                    # atomic admission: the whole batch enqueues or the
                    # request 429s with no device work at all
                    futs = batcher.submit_many(imgs) if imgs else []
                    for i, f in zip(slots, futs):
                        results[i] = f.result(timeout=60)
                    observe_once()
                    self._count(results)
                    self._json(200, {"results": results})
                else:
                    self._json(404, {"error": "unknown path"})
            except serving.Overloaded as exc:
                # never enqueued: answer at once, with a Retry-After from
                # the live queue depth and the measured dispatch time
                observe_once()
                try:
                    self._json(429, {"error": str(exc)},
                               headers={"Retry-After":
                                        str(batcher.retry_after_seconds())})
                except OSError:
                    pass
            except (BrokenPipeError, ConnectionResetError):
                # the client hung up while we wrote the response
                observe_once()
                stats.inc("serving_client_disconnects_total")
            except Exception as exc:
                # an internal failure (a device stall, a future timeout):
                # 500, so that balancers retry, counted for alerts
                log.exception("internal error")
                observe_once()
                stats.inc("serving_internal_errors_total")
                try:
                    self._json(500, {"error": str(exc)})
                except OSError:
                    pass

    class Server(ThreadingHTTPServer):
        def handle_error(self, request, client_address):
            # a client that resets its connection between requests
            if isinstance(sys.exc_info()[1], (ConnectionResetError,
                                              BrokenPipeError)):
                stats.inc("serving_client_disconnects_total")
                return
            super().handle_error(request, client_address)

    server = Server((host, port), Handler)
    server.batcher = batcher
    server.decode_pool = pool
    return server


def stop_server(server: ThreadingHTTPServer) -> None:
    """Stop a server: no new connections (at once where ``serve_forever``
    has returned), the batcher's queued futures failed, the decode pool
    joined, the socket closed."""
    server.shutdown()
    server.batcher.stop()
    server.decode_pool.shutdown(wait=True)
    server.server_close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # the checkpoint-only flags default to None, which tells a flag given
    # from one left out (export.reject_checkpoint_flags)
    p.add_argument("--config", help="preset name (default mpii_rank1_224)")
    p.add_argument("--workdir", help="run dir containing checkpoints/")
    p.add_argument("--exported_dir",
                   help="serve an exported artifact (export_cli.py)")
    p.add_argument("--port", type=int, default=8800, help="HTTP port")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    add_bool_flag(p, "int8", None, "serve the quantized BN-folded path")
    add_bool_flag(p, "ema", None,
                  "serve the EMA weights (requires ema_decay training)")
    add_bool_flag(p, "data_parallel", False,
                  "shard each batch across all local devices")
    p.add_argument("--calibration_images", action="append",
                   help="representative image for static int8 activation "
                   "scales; repeatable (omit for per-example scales)")
    p.add_argument("--topk", type=int, default=5,
                   help="top-k classes to report")
    p.add_argument("--step", help="checkpoint step: an int, or 'best' for "
                   "the keep-best slot (default latest)")
    p.add_argument("--buckets",
                   help="comma-separated batch-size buckets (default "
                   "1,8,32)")
    p.add_argument("--max_batch", type=int, default=32,
                   help="dynamic batcher max coalesced batch")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="dynamic batcher max wait")
    p.add_argument("--max_queue", type=int, default=256,
                   help="max queued requests before new ones get a fast "
                   "429 + Retry-After")
    p.add_argument("--idle_timeout", type=float, default=30.0,
                   help="close a connection after this many seconds with "
                   "no request on it (0: never)")
    p.add_argument("--max_connections", type=int, default=128,
                   help="cap on open client connections; those past it get "
                   "an immediate 503 + close (0: no cap)")
    p.add_argument("--decode_threads", type=int, default=4,
                   help="threads that decode request images (each keeps "
                   "one nvJPEG decoder on a card)")
    add_bool_flag(p, "follow", False,
                  "poll the checkpoint dir and hot-swap newer steps into "
                  "the live server; composes with --step best")
    p.add_argument("--poll_seconds", type=float, default=10.0,
                   help="--follow checkpoint poll period")
    p.add_argument("--set", action="append",
                   help="config override field=value; repeatable")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default cuda)")
    return p.parse_args(argv)


def config_from_args(args) -> config_lib.TrainConfig:
    """The config of ``--config``, ``--set`` and ``--workdir``."""
    overrides = config_lib.parse_overrides(args.set or [])
    overrides["workdir"] = args.workdir
    return config_lib.get_config(args.config or "mpii_rank1_224",
                                 **overrides)


def load_served(args) -> serving.BucketedPredictor:
    """The predictor the flags ask for: the artifact of
    ``--exported_dir``, or a checkpoint of ``--workdir``."""
    if args.follow:
        if args.exported_dir:
            raise SystemExit(
                "--follow tracks a checkpoint dir; an exported artifact is "
                "immutable — serve it without --follow")
        if args.step is not None and args.step.strip().lower() != "best":
            raise SystemExit(
                "--follow with a pinned numeric --step cannot advance; "
                "drop --step (follow latest) or use --step best")
    if args.exported_dir:
        from attentionalpoolingaction_torch import export as export_lib

        export_lib.reject_checkpoint_flags(
            args, ("config", "workdir", "int8", "ema", "step",
                   "calibration_images", "set", "buckets"))
        return export_lib.load_exported(args.exported_dir,
                                        data_parallel=args.data_parallel,
                                        device=args.device)
    if not args.workdir:
        raise SystemExit("one of --workdir / --exported_dir is required")
    return serving.load_predictor(
        config_from_args(args), step=args.step, int8=bool(args.int8),
        buckets=[int(b) for b in (args.buckets or "1,8,32").split(",")],
        calibration_files=args.calibration_images or (),
        use_ema=bool(args.ema), data_parallel=args.data_parallel,
        device=args.device)


def main(argv=None) -> None:
    args = parse_args(argv)
    predictor = load_served(args)
    log.info("warming up buckets %s", predictor.buckets)
    predictor.warmup()
    follower = None
    if args.follow:
        mgr, _ = ckpt_lib.manager_for_step(predictor.cfg.workdir, args.step)
        follower = serving.CheckpointFollower(
            predictor, mgr, use_ema=bool(args.ema),
            poll_seconds=args.poll_seconds)
        follower.start()
        log.info("following %s every %.1fs", mgr.directory,
                 args.poll_seconds)
    server = make_server(predictor, args.host, args.port, args.topk,
                         args.max_batch, args.max_wait_ms,
                         max_queue=args.max_queue,
                         idle_timeout=args.idle_timeout or None,
                         max_connections=args.max_connections or None,
                         decode_threads=args.decode_threads)
    log.info("serving %s on %s:%d (int8=%s, device=%s)",
             args.exported_dir or predictor.cfg.dataset, args.host,
             server.server_address[1], predictor.int8, predictor.device)

    # SIGTERM: stop accepting, let in-flight handlers finish, fail the
    # still-queued futures at once
    def on_term(sig, frame):
        log.warning("SIGTERM: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if follower is not None:
            follower.stop()
        stop_server(server)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
