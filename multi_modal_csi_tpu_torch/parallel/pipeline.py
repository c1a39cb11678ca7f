"""Pipeline parallelism: GPipe's microbatched schedule over a mesh axis
(counterpart of the JAX package's ``parallel/pipeline.py``).

A stack of homogeneous stages (``x = stage(params_i, x)`` with the output
shaped as the input: residual blocks, THAT's encoder blocks) is laid out
one stage a rank over the "pipe" axis; microbatches stream through the
stages with activations hopping from stage to stage by ``ppermute``, so
each rank holds one stage's parameters.

The schedule is JAX's: ``n_micro + n_stages - 1`` ticks; at tick t stage
0 takes microbatch t, stage s works on microbatch t - s, and the last
stage drains slot t - (n_stages - 1). As in JAX every stage computes at
every tick, the fill and drain included (on what it holds, results that
are never written), and stage 0 selects its feed with ``where``: so on
every rank each hop's output feeds the next tick, every hop lies on the
path from the outputs, and the backward runs every hop's inverse on
every rank in the same order (a rank whose graph skipped a hop would
leave its neighbour's send unmatched). JAX's last hop, whose result goes
unread, is skipped.

The outputs come back on every rank of the pipe axis: the last stage's
drain buffer is summed over the axis (``reduce_from_region``: the sum in
the forward, the gradient passed through unchanged). When every rank
computes the same loss of those outputs and calls ``backward``, the last
stage receives the gradient once, as JAX's single program does
(``psum``, which all-reduces the gradient too, would multiply it by the
axis's size). The whole pipeline is differentiable through autograd (the
hops' backward is the inverse permutation).

Every rank runs this inside ``axis_scope`` of a mesh with the pipe axis;
unbound (one process) it runs the stages one after the other.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch

from .collectives import (axis_index, axis_size, local_slice, ppermute,
                          reduce_from_region)

PIPE_AXIS = "pipe"

Params = Mapping[str, torch.Tensor]


def stack_stage_params(stage_params: Sequence[Params]) -> Params:
    """Stack per-stage parameter dicts along a new leading stage
    dimension: each tensor becomes ``(n_stages, *shape)``."""
    return {name: torch.stack([p[name] for p in stage_params])
            for name in stage_params[0]}


def _stage(stacked: Params, i: int) -> Params:
    return {name: t[i] for name, t in stacked.items()}


def _n_stages(stacked: Params) -> int:
    return next(iter(stacked.values())).shape[0]


def pipeline_apply(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                   stacked_params: Params, microbatches: torch.Tensor,
                   axis: str = PIPE_AXIS,
                   data_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``x -> stage_fn(p[n-1], ... stage_fn(p[0], x))`` as a pipeline.

    ``stacked_params``: a dict of tensors with a leading ``n_stages``
    dimension (``stack_stage_params``), the pipe axis's size; this rank
    takes its stage's slice, and ``stage_fn(params_i, x)`` returns x's
    shape (``torch.func.functional_call`` over a module fits).
    ``microbatches``: ``(n_micro, mb, ...)``, the batch split into
    microbatches, the same on every rank. ``data_axis``: a second mesh
    axis over which each microbatch's rows (dimension 1) are split, JAX's
    combined DP x PP: each data rank runs the pipeline on its rows.

    Returns ``(n_micro, mb, ...)`` (this rank's rows with ``data_axis``),
    equal to the stages applied one after the other to each microbatch,
    on every rank of the pipe axis."""
    n_stages = axis_size(axis)
    if _n_stages(stacked_params) != n_stages:
        raise ValueError(f"{_n_stages(stacked_params)} stacked stages on a "
                         f"{axis!r} axis of {n_stages} ranks")
    if data_axis is not None:
        microbatches = local_slice(microbatches, 1, data_axis)
    if n_stages == 1:
        return serial_reference(stage_fn, stacked_params, microbatches)
    stage = axis_index(axis)
    params = _stage(stacked_params, stage)
    n_micro = microbatches.shape[0]
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == n_stages - 1, device=microbatches.device)
    perm = [(j, (j + 1) % n_stages) for j in range(n_stages)]
    ticks = n_micro + n_stages - 1
    x = torch.zeros_like(microbatches[0])
    drained = []
    for t in range(ticks):
        feed = microbatches[min(t, n_micro - 1)]
        y = stage_fn(params, torch.where(first, feed, x))
        if t >= n_stages - 1:       # the last stage completes t - (n - 1)
            drained.append(y)
        if t < ticks - 1:
            x = ppermute(y, axis, perm)
    outs = torch.stack(drained)
    return reduce_from_region(torch.where(last, outs, torch.zeros_like(outs)),
                              axis)


def serial_reference(stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                     stacked_params: Params,
                     microbatches: torch.Tensor) -> torch.Tensor:
    """The pipeline's function without the pipeline (the tests' oracle):
    each stage applied to each microbatch in turn."""
    x = microbatches
    for i in range(_n_stages(stacked_params)):
        p = _stage(stacked_params, i)
        x = torch.stack([stage_fn(p, x[j]) for j in range(x.shape[0])])
    return x
