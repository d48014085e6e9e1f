"""The device side of the input pipeline: the port of the JAX package's
``data/pipeline.py`` :331-503 (its tf.data readers have no counterpart:
the port reads through ``grain_pipeline.py``).

  * :func:`prefetch_to_device` keeps ``size`` batches in flight on the
    device;
  * :class:`StatefulPrefetchIterator` does the same for a checkpointable
    iterator, and its ``get_state()`` is the state after the last batch the
    loop *consumed*, not the prefetch position;
  * :class:`EchoIterator` hands each batch out ``echo`` times (data
    echoing), the echoed batch reused on the device; its state is
    ``{"inner_before", "phase"}``.

On a CUDA device a batch is pulled from the inner iterator on a side
stream: what the pull enqueues there (the JPEG decode and resize of the
train pipeline) and the non-blocking copies of its host arrays from
pinned memory overlap the consumer's work, and the consumer's stream
waits on an event recorded after them.  Tensors already on the device
pass through.  None of this touches a value.
"""

from __future__ import annotations

import collections
from typing import Iterator

import numpy as np
import torch

from attentionalpoolingaction_torch.device import resolve_device

__all__ = ["EchoIterator", "StatefulPrefetchIterator", "prefetch_to_device",
           "to_device"]


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def to_device(batch, device: torch.device) -> dict:
    """Every feature of ``batch`` as a tensor on ``device``; host arrays to
    a card through pinned memory, without waiting for the copy."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        if _on_device(t, device):
            out[k] = t
        elif device.type == "cuda" and t.device.type == "cpu":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out


class _Puller:
    """``pull(it)``: the next batch of ``it`` put on the device, with the
    event its consumer waits on (None on the CPU); ``ready`` makes the
    current stream wait for it."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def pull(self, it):
        if self._side is None:
            return to_device(next(it), self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            batch = to_device(next(it), self.device)
            event = torch.cuda.Event()
            event.record(self._side)
        return batch, event

    def ready(self, batch: dict, event) -> dict:
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                # the memory was allocated on the side stream; tell the
                # allocator that the consumer's stream uses it now
                t.record_stream(stream)
        return batch


def prefetch_to_device(iterator, size: int = 2, device=None) -> Iterator:
    """Overlap batch production and the host-to-device copy with the
    device's work: keep ``size`` batches in flight on ``device`` (default
    ``cuda``)."""
    puller = _Puller(device)
    queue = collections.deque()
    it = iter(iterator)
    while True:
        try:
            queue.append(puller.pull(it))
        except StopIteration:
            break
        if len(queue) >= size:
            yield puller.ready(*queue.popleft())
    while queue:
        yield puller.ready(*queue.popleft())


class StatefulPrefetchIterator:
    """Device prefetch for a STATEFUL (checkpointable) iterator without
    losing exact resume: the inner state is snapshotted right after each
    pull and buffered with its batch, so ``get_state()`` returns the
    snapshot paired with the last *consumed* batch while the next batch's
    preparation and copy overlap the current step."""

    def __init__(self, iterator, size: int = 2, device=None):
        self._it = iterator
        self._size = max(1, int(size))
        self._puller = _Puller(device)
        self._queue = collections.deque()   # (state_after, batch, event)
        # before the first __next__: the inner iterator's CURRENT position
        # (the restored one when train() has just called set_state)
        self._consumed_state = iterator.get_state()
        self._exhausted = False

    def _fill(self):
        while not self._exhausted and len(self._queue) < self._size:
            try:
                batch, event = self._puller.pull(self._it)
            except StopIteration:
                self._exhausted = True
                return
            # snapshot BEFORE the next pull: "batch and everything before
            # it consumed" is what a resume after consuming it restores
            self._queue.append((self._it.get_state(), batch, event))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._queue:
            raise StopIteration
        state, batch, event = self._queue.popleft()
        self._consumed_state = state
        return self._puller.ready(batch, event)

    def get_state(self):
        return self._consumed_state

    def set_state(self, state):
        self._queue.clear()
        self._exhausted = False
        self._it.set_state(state)
        self._consumed_state = state


class EchoIterator:
    """Batch-level data echoing (Choi et al. 2019): yield each upstream
    batch ``echo`` consecutive times, so an input-bound host feeds ``echo``
    optimizer steps a pipeline batch.  It sits above the device prefetch,
    so a repeat reuses the same batch on the device.

    Exact resume when the inner iterator is stateful: the state is {inner
    state BEFORE the current batch was pulled, echo phase}; restoring with
    phase > 0 pulls that batch again from the restored inner state (the
    pipeline is deterministic), so a mid-echo checkpoint loses nothing."""

    def __init__(self, iterator, echo: int):
        if echo < 1:
            raise ValueError(f"echo must be >= 1, got {echo}")
        self._it = iterator
        self._echo = int(echo)
        self._stateful = hasattr(iterator, "get_state")
        self._inner_before = (iterator.get_state() if self._stateful
                              else None)
        self._batch = None
        self._phase = 0          # echoes of the current batch already out

    def __iter__(self):
        return self

    def __next__(self):
        if self._phase == 0:
            if self._stateful:
                self._inner_before = self._it.get_state()
            self._batch = next(self._it)   # StopIteration propagates
        self._phase = (self._phase + 1) % self._echo
        return self._batch

    def get_state(self):
        if not self._stateful:
            raise AttributeError("inner iterator is not checkpointable")
        if self._phase == 0:
            # cycle boundary: the last batch is fully consumed, so the
            # state is the inner's live position
            return {"inner_before": self._it.get_state(), "phase": 0}
        return {"inner_before": self._inner_before, "phase": self._phase}

    def set_state(self, state):
        self._it.set_state(state["inner_before"])
        # a checkpoint taken mid-echo after this restore (before the next
        # batch boundary) must save the same inner_before again
        self._inner_before = state["inner_before"]
        self._phase = int(state["phase"])
        self._batch = next(self._it) if self._phase else None
