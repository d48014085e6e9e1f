"""The open-loop load generator of the HTTP cells, run as a process of its
own (it imports no torch):

    python3 -m bench_h100.drivers.loadgen --spec SPEC.json --out OUT.json

``SPEC.json``: ``port``, ``start`` (a ``time.monotonic()`` instant, which
every process on the host shares), ``times`` (each request's send time
after ``start``), ``images`` (the pool index each request sends),
``pool_file`` and ``offsets`` (the pool's JPEGs, back to back),
``connections`` and ``deadline_s`` (after ``start``: requests still
unanswered then count as failed).

Requests are sent on schedule, whatever came back, over at most
``connections`` keep-alive connections: one due while every connection
waits for an answer waits for the first free one (the time counts against
it).  ``OUT.json`` holds, a request each, when it was sent, when the last
byte of its answer came, its status (0: no answer) and its body; and how
late the generator ran: the delay between a request's due time and the
moment the generator handed it to a connection.  That lateness is also
printed on standard error.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


async def _exchange(reader, writer, body: bytes, port: int):
    writer.write(b"POST /predict HTTP/1.1\r\nHost: 127.0.0.1:%d\r\n"
                 b"Content-Type: image/jpeg\r\nContent-Length: %d\r\n\r\n"
                 % (port, len(body)) + body)
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    length = 0
    close = False
    for line in lines[1:]:
        k, _, v = line.partition(":")
        if k.strip().lower() == "content-length":
            length = int(v)
        elif k.strip().lower() == "connection" and "close" in v.lower():
            close = True
    payload = await reader.readexactly(length)
    return status, payload, close


async def _run(spec: dict, pool: list[bytes]) -> dict:
    n = len(spec["times"])
    port = spec["port"]
    start = spec["start"]
    sent = [0.0] * n
    handed = [0.0] * n
    done = [0.0] * n
    status = [0] * n
    body = [""] * n
    queue: asyncio.Queue = asyncio.Queue()

    async def worker():
        reader = writer = None
        while True:
            i = await queue.get()
            if i is None:
                break
            for _attempt in range(2):
                try:
                    if writer is None:
                        reader, writer = await asyncio.open_connection(
                            "127.0.0.1", port)
                    sent[i] = time.monotonic()
                    st, payload, close = await _exchange(
                        reader, writer, pool[spec["images"][i]], port)
                    done[i] = time.monotonic()
                    status[i], body[i] = st, payload.decode()
                    if close:
                        writer.close()
                        reader = writer = None
                    break
                except (OSError, asyncio.IncompleteReadError, ValueError,
                        IndexError):
                    if writer is not None:
                        writer.close()
                    reader = writer = None
        if writer is not None:
            writer.close()

    workers = [asyncio.create_task(worker())
               for _ in range(int(spec["connections"]))]
    for i, t in enumerate(spec["times"]):
        delay = start + t - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
        handed[i] = time.monotonic()
        queue.put_nowait(i)
    for _ in workers:
        queue.put_nowait(None)
    left = start + spec["deadline_s"] - time.monotonic()
    finished, pending = await asyncio.wait(workers, timeout=max(left, 0.1))
    for w in pending:
        w.cancel()
    for w in finished:
        w.result()
    late = sorted(handed[i] - (start + spec["times"][i]) for i in range(n))
    lateness = {"p50_ms": 1e3 * late[n // 2] if n else 0.0,
                "p99_ms": 1e3 * late[min(n - 1, int(0.99 * n))] if n else 0.0,
                "max_ms": 1e3 * late[-1] if n else 0.0}
    return {"sent": sent, "done": done, "status": status, "body": body,
            "handed": handed, "lateness": lateness}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--spec", required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    with open(a.spec) as f:
        spec = json.load(f)
    with open(spec["pool_file"], "rb") as f:
        blob = f.read()
    offs = spec["offsets"]
    pool = [blob[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    out = asyncio.run(_run(spec, pool))
    with open(a.out, "w") as f:
        json.dump(out, f)
    print("loadgen lateness (due to handed to a connection): "
          + json.dumps(out["lateness"]), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
