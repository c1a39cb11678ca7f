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
- ``average_gradients``: the data-parallel step's gradient all-reduce,
  over the "data" axis only (ranks along "model" hold different shards);
- the model axis's primitives (``parallel/partition.py``'s rules run on
  them): Megatron's conjugate pair, ``copy_to_region`` (the identity
  forward, an all-reduce backward: where a replicated activation or
  parameter enters a sharded region) and ``reduce_from_region`` (an
  all-reduce forward, the identity backward: at a row-parallel output);
  ``gather_features``, an all-gather along a feature dimension whose
  backward is a reduce-scatter; ``local_slice``, this rank's part of a
  dimension;
- ``ppermute``: JAX's ``lax.ppermute`` with autograd, point-to-point sends
  over the axis's group whose backward applies the inverse permutation
  (GPipe's activation hops, ring attention's K/V rotation).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _AllGather.forward(ctx, x.movedim(dim, 0), group).movedim(
            0, dim)

    @staticmethod
    def backward(ctx, grad):
        out, _ = _AllGather.backward(ctx, grad.movedim(ctx.dim, 0))
        return out.movedim(0, ctx.dim), None, None


def _send_recv(x: torch.Tensor, group: dist.ProcessGroup,
               pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Each (source, destination) axis index pair sends ``x`` from its
    source to its destination; a rank that no pair reaches gets zeros."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _send_recv(x, group, pairs)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(dst, src) for src, dst in ctx.pairs]
        return _send_recv(grad, ctx.group, inverse), None, None


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


def copy_to_region(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over the axis's ranks: a
    replicated activation (or parameter) entering a region sharded over
    the axis, where each rank's gradient is its shard's part (the
    identity unbound)."""
    group = _group(axis)
    return x if group is None else _ReduceBackward.apply(x, group)


def reduce_from_region(x: torch.Tensor, axis: str = "model"
                       ) -> torch.Tensor:
    """The sum of ``x`` over the axis's ranks, whose gradient passes
    through unchanged: a row-parallel product's output, whose sum every
    rank then holds (the identity unbound). ``psum`` would all-reduce the
    gradient too, and so multiply it by the axis's size upstream."""
    group = _group(axis)
    return x if group is None else _ReduceForward.apply(x, group)


def gather_features(x: torch.Tensor, axis: str = "model",
                    dim: int = -1) -> torch.Tensor:
    """Concatenate ``x`` over the axis's ranks along ``dim``, in rank
    order (the identity unbound); the gradient of each rank's part is the
    sum of every rank's gradient of it (a reduce-scatter)."""
    group = _group(axis)
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _GatherFeatures.apply(x, group, dim % x.dim())


def ppermute(x: torch.Tensor, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """JAX's ``lax.ppermute``: for each (source, destination) pair of axis
    indices, the destination receives the source's ``x``; a rank no pair
    reaches gets zeros. The sends run as one ``batch_isend_irecv`` on the
    axis's group (global ranks from ``dist.get_global_rank``), and the
    gradient travels the inverse pairs. Unbound, or on an axis of one
    rank, no send is issued: ``x`` itself where the pairs map 0 to 0,
    else zeros."""
    pairs = tuple((int(s), int(d)) for s, d in perm)
    group = _group(axis)
    if group is None or dist.get_world_size(group) == 1:
        return x if (0, 0) in pairs else torch.zeros_like(x)
    return _Permute.apply(x, group, pairs)


def global_rows(shape: Tuple[int, ...], axis: str = "data"
                ) -> Tuple[int, ...]:
    """``shape`` with dimension 0 widened to the global batch's."""
    return (shape[0] * axis_size(axis), *shape[1:])


def local_rows(t: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """This rank's rows of ``t``, drawn at ``global_rows``'s shape."""
    return local_slice(t, 0, axis)


def local_slice(t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's equal part of ``t`` along ``dim`` over the axis (``t``
    itself unbound)."""
    size = axis_size(axis)
    if size == 1:
        return t
    part = t.shape[dim] // size
    return t.narrow(dim, axis_index(axis) * part, part)


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
def average_gradients(params: Iterable[torch.nn.Parameter],
                      axis: str = "data") -> None:
    """Replace each gradient by its mean over the axis's ranks (nothing
    unbound): one all-reduce of the gradients flattened per dtype, in
    parameter order. Only the data axis's ranks hold the same parameters;
    ranks along "model" hold different shards of a tensor-parallel one,
    whose gradient is this rank's shard's (a DTensor's local part).
    Parameters without a gradient are skipped, which every rank does
    alike since every rank runs the same graph."""
    group = _group(axis)
    if group is None:
        return
    grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
             for p in params if p.grad is not None]
    size = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=group)
        flat /= size
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
