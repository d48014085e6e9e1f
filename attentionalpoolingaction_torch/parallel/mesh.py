"""The mesh over the processes, the sharding plan of the train state, and
the collectives of the train step: the port of the JAX package's
``parallel/mesh.py`` over ``torch.distributed``.

JAX runs one controller over a device mesh and lets GSPMD place the
collectives.  The port runs one process a card (``multihost.setup``), and
the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes with JAX's axis names:

  * ``data``: each process holds its share of the batch's rows; the
    gradients are all-reduced over the axis, batch norm's train-mode
    statistics too (``models/resnet.py``);
  * ``model`` (optional): the attentional-pooling head's class dimension
    shards over the axis (``models/heads.py``); processes along it see
    the same rows.

:func:`state_shardings` is JAX's plan, leaf by leaf, as a table of
:class:`LeafPlan`: replicated, class-sharded over ``model`` (tensor
parallelism of the head), or, with ZeRO-1, each optimizer-state leaf
sliced over ``data`` on its widest evenly divisible dimension.  The
choice is made on the Flax layout of each leaf, so that it is the same
dimension JAX picks, and mapped to the port's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from attentionalpoolingaction_torch import convert

__all__ = ["LeafPlan", "all_gather_cat", "all_reduce_flat",
           "all_reduce_sum", "axis_group",
           "axis_index", "axis_size", "gather_classes", "make_mesh",
           "model_axis_of", "reduce_grad", "shard_batch", "shard_batches",
           "state_shardings"]

# elements a bucket of the flat gradient all-reduce
BUCKET_ELEMENTS = 1 << 24


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data",)):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks
    of the process group, row-major as JAX lays out ``devices[:n]``.
    ``shape=None`` puts every rank on the first axis.  Raises, as JAX's
    does, when the shape needs more ranks than there are."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise ValueError("make_mesh needs a process group: call "
                         "parallel.multihost.setup() first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axis_names)} "
                         "differ in length")
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis`` that holds this rank (None where the
    axis is absent)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def model_axis_of(mesh) -> str | None:
    """The tensor-parallel axis name if the mesh has a non-trivial one."""
    return "model" if axis_size(mesh, "model") > 1 else None


def shard_batch(batch: Mapping, mesh, axis: str = "data", device=None
                ) -> dict:
    """This rank's rows of a host batch (the same global batch on every
    rank), as tensors on ``device`` (default: the rows' own).  The batch
    dimension must divide evenly over ``axis``."""
    d, i = axis_size(mesh, axis), axis_index(mesh, axis)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % d:
            raise ValueError(f"batch {b} not divisible by the {axis!r} axis "
                             f"size {d}")
        rows = v[i * (b // d):(i + 1) * (b // d)]
        t = rows if isinstance(rows, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(rows))
        out[k] = t if device is None else t.to(device)
    return out


def shard_batches(iterator, mesh, axis: str = "data", device=None):
    """:func:`shard_batch` of each batch of a stream."""
    for batch in iterator:
        yield shard_batch(batch, mesh, axis, device)


# -- the sharding plan ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one leaf is held: ``replicated``, ``model`` (a slice of
    dimension ``dim`` over the model axis) or ``zero1`` (a slice of ``dim``
    over the data axis).  ``dim`` is the port's dimension, ``flax_dim``
    the same dimension in the Flax layout."""
    kind: str = "replicated"
    dim: int | None = None
    flax_dim: int | None = None

    @property
    def axis(self) -> str | None:
        """The mesh axis the leaf is sliced over."""
        return {"model": "model", "zero1": "data"}.get(self.kind)


REPLICATED = LeafPlan()


def flax_layout(name: str, shape: Sequence[int]):
    """``(Flax path, Flax shape, port dim of each Flax dim)`` of the
    port's parameter ``name`` of ``shape``: conv kernels are OIHW in the
    port and HWIO in Flax, the avg head's dense kernel (C, F) and (F, C)
    (the weight bridge's transposes, ``convert.py``)."""
    coll, path, _ = convert._unmap(
        name, np.broadcast_to(np.float32(0), tuple(shape)))
    if len(shape) == 4:
        perm = (2, 3, 1, 0)
    elif name.endswith("logits.weight"):
        perm = (1, 0)
    else:
        perm = tuple(range(len(shape)))
    return (coll,) + tuple(path), tuple(shape[k] for k in perm), perm


def _zero1_plan(flax_shape, to_port, size: int) -> LeafPlan:
    if not flax_shape:
        return REPLICATED
    # the widest dimension the axis divides evenly (conv kernels: the
    # output channels; biases and BN: the only dim), the first on a tie
    cands = [d for d in range(len(flax_shape)) if flax_shape[d] % size == 0]
    if not cands:
        return REPLICATED
    d = max(cands, key=lambda d: flax_shape[d])
    return LeafPlan("zero1", to_port[d], d)


_TP_DIMS = {("attn_w", 3): 1, ("attn_b", 2): 0, ("kernel", 2): 1,
            ("bias", 1): 0}


def _leaf_plan(path, flax_shape, to_port, *, opt: bool, model_size: int,
               zero_size: int) -> LeafPlan:
    # path: (collection, module..., leaf), as JAX's leaf_sharding reads it
    if model_size > 1 and "head" in path[1:]:
        d = _TP_DIMS.get((path[-1], len(flax_shape)))
        if d is not None:
            if flax_shape[d] % model_size == 0:
                return LeafPlan("model", to_port[d], d)
            return REPLICATED
    if opt and zero_size > 1:
        return _zero1_plan(flax_shape, to_port, zero_size)
    return REPLICATED


@dataclasses.dataclass
class ShardingPlan:
    """The plan of a train state, by the port's parameter name: ``params``
    (the parameters, their gradients and their EMA) and ``opt_state`` (the
    optimizer's buffers of each parameter).  ``flax`` maps each name to
    its Flax path, for reading the plan against JAX's."""
    params: dict[str, LeafPlan]
    opt_state: dict[str, LeafPlan]
    flax: dict[str, tuple]
    model_size: int = 1


def state_shardings(mesh, model: nn.Module, *, model_axis: str | None = None,
                    zero1_axis: str | None = None,
                    full_shapes: Mapping[str, Sequence[int]] | None = None
                    ) -> ShardingPlan:
    """The plan of JAX's ``state_shardings`` for ``model``'s parameters.

    Default: everything replicated (pure data parallelism).  With
    ``model_axis``, the head's class dimension shards over it where the
    axis divides it evenly (``attn_w`` (F, C, P) on C, ``attn_b`` (C, P)
    on C, the avg head's kernel and bias on C; MPII's 393 stays
    replicated), for the parameter and its optimizer buffers alike.  With
    ``zero1_axis``, each other optimizer buffer is sliced over the axis on
    its widest evenly divisible dimension.  Batch norm's statistics are
    always replicated.  ``full_shapes`` gives the unsharded shape of a
    parameter already sliced by the head."""
    model_size = axis_size(mesh, model_axis) if model_axis else 1
    zero_size = axis_size(mesh, zero1_axis) if zero1_axis else 1
    params, opt_state, flax = {}, {}, {}
    for name, p in model.named_parameters():
        shape = tuple((full_shapes or {}).get(name, p.shape))
        path, flax_shape, to_port = flax_layout(name, shape)
        flax[name] = path
        kw = dict(model_size=model_size, zero_size=zero_size)
        params[name] = _leaf_plan(path, flax_shape, to_port, opt=False, **kw)
        opt_state[name] = _leaf_plan(path, flax_shape, to_port, opt=True,
                                     **kw)
    return ShardingPlan(params, opt_state, flax, model_size)


def shard_slice(t: torch.Tensor, plan: LeafPlan, index: int,
                count: int) -> torch.Tensor:
    """Slice ``index`` of ``count`` of ``t`` along the plan's dim (``t``
    itself when replicated)."""
    if plan.kind == "replicated":
        return t
    n = t.shape[plan.dim] // count
    return t.narrow(plan.dim, index * n, n)


# -- collectives -------------------------------------------------------------

def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None,
                    op=dist.ReduceOp.SUM) -> int:
    """All-reduce ``tensors`` in place as flat buckets of at most
    ``BUCKET_ELEMENTS`` elements of one dtype: a few collectives for a
    model's gradients instead of one a tensor.  Returns the number of
    collectives."""
    count = 0
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        bucket, size = [], 0
        for t in group_ts + [None]:
            if t is not None and (not bucket
                                  or size + t.numel() <= BUCKET_ELEMENTS):
                bucket.append(t)
                size += t.numel()
                continue
            if bucket:
                flat = torch.cat([b.reshape(-1) for b in bucket])
                dist.all_reduce(flat, op=op, group=group)
                count += 1
                off = 0
                for b in bucket:
                    b.copy_(flat[off:off + b.numel()].view_as(b))
                    off += b.numel()
            if t is not None:
                bucket, size = [t], t.numel()
            else:
                bucket = []
    return count


def all_gather_cat(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in rank order."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """A differentiable all-reduce (sum) over the group: the gradient of
    every rank's input is the sum of the cotangents of every rank's
    output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceGrad(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the
    group (the gradient of a replicated input that each rank uses for its
    own shard of the classes)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherClasses(torch.autograd.Function):
    """All-gather of (B, C/m) logits along the classes over the model
    group.  The loss after it is computed alike on every rank of the
    group, so the backward takes this rank's columns of the (equal)
    cotangents, with no collective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        ctx.c = x.shape[1]
        return all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rank * ctx.c:(ctx.rank + 1) * ctx.c], None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceGrad.apply(x, group)


def gather_classes(logits: torch.Tensor, group) -> torch.Tensor:
    return _GatherClasses.apply(logits, group)
