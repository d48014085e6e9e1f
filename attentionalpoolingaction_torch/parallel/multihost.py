"""Multi-process runtime: the port of the JAX package's
``parallel/multihost.py`` over ``torch.distributed``.

The port runs one process a card.  :func:`setup` joins this process to the
job, from arguments or from the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): on a
card over NCCL, on ``cuda:LOCAL_RANK``; over gloo only when the caller
asks for the CPU or names the backend.  A failed NCCL init raises; nothing
falls back to another backend.

The helpers are collectives: every process calls them in the same order.
Each is the identity in a single process (no process group, or a group of
one), as the JAX functions are with one process.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["FlagAllReduce", "allgather_host_arrays", "allreduce_flag",
           "assert_same_across_hosts", "barrier", "broadcast_step",
           "comm_device", "local_rank", "process_count", "process_index",
           "setup"]

log = logging.getLogger(__name__)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def comm_device(group=None) -> torch.device:
    """The device of the tensors that ``group``'s collectives take: the
    current card for NCCL, the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def setup(coordinator_address: str | None = None,
          num_processes: int | None = None,
          process_id: int | None = None, *, device=None,
          backend: str | None = None) -> torch.device:
    """Join the job and return this process's device.

    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK``.  ``device`` "cpu" (or ``backend="gloo"``) joins over gloo;
    otherwise the process takes ``cuda:LOCAL_RANK`` and joins over NCCL.
    Already joined: returns the device without joining again."""
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to join over gloo")
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        log.info("process group already initialized (rank %d of %d)",
                 dist.get_rank(), dist.get_world_size())
        return dev
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("no coordinator address: pass one or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    kw = {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=world, rank=rank, **kw)
    log.info("process %d/%d over %s on %s", rank, world, backend, dev)
    return dev


def _single() -> bool:
    return process_count() == 1


def barrier() -> None:
    if not _single():
        dist.barrier()


def assert_same_across_hosts(value: int, name: str = "value") -> None:
    """Every process must pass the same ``value`` (a global batch size,
    say): the sum over processes is checked against ``value`` times
    their number."""
    if _single():
        return
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=comm_device())
    dist.all_reduce(t)
    expected = float(value) * process_count()
    if float(t.item()) != expected:
        raise ValueError(f"{name} differs across hosts: sum "
                         f"{float(t.item())} != {expected}")


def broadcast_step(step: int | None) -> int | None:
    """Process 0's checkpoint step wins everywhere (``None`` travels as
    -1): processes polling a checkpoint directory may see different
    latest steps, and the sharded eval's gather must pair one step."""
    if _single():
        return step
    t = torch.tensor([-1 if step is None else int(step)],
                     dtype=torch.int64, device=comm_device())
    dist.broadcast(t, src=0)
    s = int(t.item())
    return None if s < 0 else s


def allreduce_flag(flag: bool) -> bool:
    """The OR of a bool over the processes (blocking)."""
    r = FlagAllReduce()
    return r.read(r.dispatch(flag))


class FlagAllReduce:
    """Non-blocking OR over the processes of a per-process bool, for the
    preemption stop: every process calls :meth:`dispatch` with its local
    flag at every step (an ``all_reduce(MAX, async_op=True)``) and
    :meth:`read`\\ s the previous step's handle, so that all of them see
    the stop at the same step.  Single process: the plain flag."""

    def __init__(self):
        self._single = _single()
        self._device = None if self._single else comm_device()

    def dispatch(self, flag: bool):
        if self._single:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self._device)
        return t, dist.all_reduce(t, op=dist.ReduceOp.MAX, async_op=True)

    def read(self, handle) -> bool:
        if self._single:
            return bool(handle)
        t, work = handle
        work.wait()
        return bool(t.item() > 0)


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t.contiguous())
    return out


def allgather_host_arrays(arrays: dict) -> dict:
    """Concatenate each process's numpy arrays along axis 0, in rank order:
    the sharded eval's combiner, after which every process computes the
    same metrics.  Row counts may differ (shard remainders): each process
    pads its rows to the largest count, so callers carry a ``mask`` (1 = a
    real row) and padding rows arrive with mask 0.  Keys are gathered in
    sorted order; every process passes the same keys and dtypes."""
    if _single():
        return arrays
    dev = comm_device()
    n = int(next(iter(arrays.values())).shape[0])
    counts = _all_gather(torch.tensor([n], dtype=torch.int64, device=dev))
    m = max(int(c.item()) for c in counts)
    out = {}
    for k in sorted(arrays):
        v = np.asarray(arrays[k])
        if v.dtype == np.bool_:
            raise TypeError(f"{k}: gather bool arrays as uint8")
        if m > n:
            v = np.pad(v, [(0, m - n)] + [(0, 0)] * (v.ndim - 1))
        parts = _all_gather(
            torch.from_numpy(np.ascontiguousarray(v)).to(dev))
        out[k] = np.concatenate([p.cpu().numpy() for p in parts])
    return out
