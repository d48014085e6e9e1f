"""ZeRO-1: the optimizer's state sliced over the mesh's data axis, the
dataflow JAX describes for its ``zero1`` sharding (``parallel/mesh.py``):
each rank keeps only its slice of each momentum buffer, updates its slice
of the parameter from the (all-reduced, whole) gradient, and the slices
are all-gathered into the whole parameter.

:class:`Zero1Optimizer` wraps a torch optimizer built over tensors of the
slices' shapes, so that the update is torch's own, element for element;
a leaf the plan keeps replicated is updated whole on every rank.  Its
``state_dict()`` gathers the slices into the whole buffers (a collective:
every rank calls it) and is the same dict a one-process optimizer saves;
``load_state_dict()`` takes such a dict and keeps this rank's slices, so a
checkpoint moves between topologies.  Only all-gather is used: gloo has no
reduce-scatter to rely on.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from attentionalpoolingaction_torch.parallel.mesh import (
    LeafPlan,
    all_gather_cat,
    shard_slice,
)

__all__ = ["Zero1Optimizer"]


class Zero1Optimizer:
    """``make_inner(tensors)`` builds the inner optimizer over one tensor a
    parameter, in ``names`` order (the order of the optimizer's state
    indices); ``params`` are the model's parameters in that order and
    ``plans`` their optimizer-state plans; ``group``, ``index`` and
    ``count`` the data axis's process group, this rank's place on it and
    its size."""

    def __init__(self, make_inner: Callable, names: Sequence[str],
                 params: Sequence[torch.Tensor],
                 plans: Sequence[LeafPlan], group, index: int, count: int):
        self.names = list(names)
        self.params = list(params)
        self.plans = list(plans)
        self.group, self.index, self.count = group, index, count
        self.sliced = [i for i, pl in enumerate(self.plans)
                       if pl.kind == "zero1"]
        self.tensors = list(self.params)
        for i in self.sliced:
            self.tensors[i] = self._slice(self.params[i].detach(), i).clone()
        self.inner = make_inner(self.tensors)
        self.param_groups = self.inner.param_groups

    def _slice(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return shard_slice(t, self.plans[i], self.index, self.count)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()
        for i in self.sliced:
            self.tensors[i].grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update: this rank's slices from the parameters (restored or
        loaded since the last step alike) and their gradients' slices,
        the inner step, then one all-gather of every updated slice."""
        for i in self.sliced:
            p, t = self.params[i], self.tensors[i]
            t.copy_(self._slice(p.detach(), i))
            t.grad = self._slice(p.grad, i).contiguous()
        self.inner.step()
        if not self.sliced:
            return
        flat = torch.cat([self.tensors[i].reshape(-1) for i in self.sliced])
        parts = [torch.empty_like(flat) for _ in range(self.count)]
        dist.all_gather(parts, flat, group=self.group)
        off = 0
        for i in self.sliced:
            t, n = self.tensors[i], self.tensors[i].numel()
            whole = torch.cat([q[off:off + n].view_as(t) for q in parts],
                              dim=self.plans[i].dim)
            self.params[i].copy_(whole)
            off += n

    def state_dict(self) -> dict:
        """The inner state with every sliced buffer gathered whole (a
        collective)."""
        sd = self.inner.state_dict()
        state = {}
        for k, buf in sd["state"].items():
            i = int(k)
            if i in self.sliced:
                buf = {name: (all_gather_cat(v, self.plans[i].dim,
                                             self.group)
                              if self._is_sliced_buffer(v, i) else v)
                       for name, v in buf.items()}
            state[k] = buf
        return {"state": state, "param_groups": sd["param_groups"]}

    def _is_sliced_buffer(self, v, i: int) -> bool:
        return (isinstance(v, torch.Tensor)
                and tuple(v.shape) == tuple(self.tensors[i].shape))

    def load_state_dict(self, sd: dict) -> None:
        """Load a whole (one-process) optimizer state dict, keeping this
        rank's slice of each buffer of a sliced parameter."""
        state = {}
        for k, buf in sd["state"].items():
            i = int(k)
            if i in self.sliced:
                full = tuple(self.params[i].shape)
                buf = {name: (self._slice(v, i).clone()
                              if isinstance(v, torch.Tensor)
                              and tuple(v.shape) == full else v)
                       for name, v in buf.items()}
            state[k] = buf
        self.inner.load_state_dict({"state": state,
                                    "param_groups": sd["param_groups"]})
