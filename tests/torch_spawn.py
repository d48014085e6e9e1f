"""Spawn a job of worker processes of the port over gloo on the CPU, for
the multi-process tests (``test_torch_parallel.py``, ``test_torch_mesh.py``),
as ``tests/test_multiprocess.py`` spawns JAX processes."""

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_workers(source: str, tmp, n: int = 2, threads: int = 2):
    """Start ``n`` processes running ``source`` as ``worker.py RANK PORT
    TMP N``; returns the Popen objects (pass them to :func:`finish`)."""
    script = pathlib.Path(tmp) / "worker.py"
    script.write_text(source)
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = str(threads)
    return [subprocess.Popen(
        [sys.executable, str(script), str(i), str(port), str(tmp), str(n)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for i in range(n)]


def finish(procs, timeout: float) -> list[str]:
    """Wait for every worker (killing all of them if one outlives
    ``timeout`` seconds, so a hang fails the test instead of the run);
    assert each exited 0 and printed ``WORKER<i> OK``; return the
    outputs."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER{i} OK" in out, out
    return outs
