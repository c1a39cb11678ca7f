"""Collectives over named mesh axes (counterpart of the JAX package's
``parallel/collectives.py``).

JAX binds an axis name inside ``shard_map`` or a sharded ``jit``; here
``axis_scope(mesh)`` binds each of a mesh's axis names to its process
group while a block runs (the training step, forward and backward). Bound,
the helpers below act over the axis's ranks; unbound (no scope, or no
process group at all) they are the identity, as JAX's are outside a mesh.

- ``psum``, ``pmean``: an all-reduce with autograd, whose backward
  all-reduces the gradient (each rank's term of the global loss reaches
  every rank's input, as ``SyncBatchNorm`` propagates it);
- ``gather_from_all``: an all-gather along batch dimension 0 with
  autograd, whose backward sums each rank's slice over the ranks (JAX's
  transpose, a psum_scatter);
- ``global_rows``/``local_rows``: a random draw made at the global
  batch's shape on every rank from the same generator, then cut to this
  rank's rows, so that a step on N ranks draws what one rank draws on the
  whole batch;
- ``gather_rows``: an all-gather without autograd (evaluation's logits);
- ``average_gradients``: the data-parallel step's gradient all-reduce.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

_AXES: Dict[str, dist.ProcessGroup] = {}


@contextlib.contextmanager
def axis_scope(mesh) -> Iterator[None]:
    """Bind every axis name of ``mesh`` (a ``DeviceMesh``) to its process
    group while the block runs; a ``None`` mesh binds nothing."""
    global _AXES
    previous = _AXES
    if mesh is not None:
        _AXES = dict(previous)
        _AXES.update({name: mesh.get_group(name)
                      for name in mesh.mesh_dim_names})
    try:
        yield
    finally:
        _AXES = previous


def _group(axis: Optional[str]) -> Optional[dist.ProcessGroup]:
    return None if axis is None else _AXES.get(axis)


def axis_present(axis: str) -> bool:
    """True inside ``axis_scope`` of a mesh with this axis name."""
    return axis in _AXES


def axis_size(axis: str = "data") -> int:
    group = _group(axis)
    return 1 if group is None else dist.get_world_size(group)


def axis_index(axis: str = "data") -> int:
    group = _group(axis)
    return 0 if group is None else dist.get_rank(group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],
                           *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((grad.shape[0]
                              // dist.get_world_size(ctx.group),
                              *grad.shape[1:]))
        dist.reduce_scatter_tensor(out, grad, group=ctx.group)
        return out, None


def psum(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Sum of ``x`` over the axis's ranks (the identity unbound)."""
    group = _group(axis)
    return x if group is None else _AllReduce.apply(x, group)


def pmean(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Mean of ``x`` over the axis's ranks (the identity unbound)."""
    group = _group(axis)
    if group is None:
        return x
    return _AllReduce.apply(x, group) / dist.get_world_size(group)


def gather_from_all(x: torch.Tensor,
                    axis: Optional[str] = "data") -> torch.Tensor:
    """Concatenate ``x`` over the axis's ranks along dimension 0 (the
    identity unbound). The gradient of each rank's slice is the sum of
    every rank's gradient of that slice."""
    group = _group(axis)
    return x if group is None else _AllGather.apply(x, group)


def global_rows(shape: Tuple[int, ...], axis: str = "data"
                ) -> Tuple[int, ...]:
    """``shape`` with dimension 0 widened to the global batch's."""
    return (shape[0] * axis_size(axis), *shape[1:])


def local_rows(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``t``, drawn at ``global_rows``'s shape."""
    size = axis_size(axis)
    if size == 1:
        return t
    rows = t.shape[0] // size
    start = axis_index(axis) * rows
    return t[start:start + rows]


@torch.no_grad()
def gather_rows(x: torch.Tensor, sharding, dim: int = 0) -> torch.Tensor:
    """Concatenate ``x`` over the data axis of ``sharding`` (a
    ``parallel.mesh.BatchSharding``) along ``dim``, without autograd
    (``x`` itself without a sharding)."""
    if sharding is None:
        return x
    group = sharding.group
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((dist.get_world_size(group) * moved.shape[0],
                           *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over every rank (the mesh covers
    the default group; ranks along "model" hold equal gradients): one
    all-reduce of the gradients flattened per dtype, in parameter order.
    Parameters without a gradient are skipped, which every rank does
    alike since every rank runs the same graph."""
    grads = [p.grad for p in params if p.grad is not None]
    size = dist.get_world_size()
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat)
        flat /= size
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
