"""FSDP placement (counterpart of the FSDP part of the JAX package's
``parallel/partition.py``): ZeRO-3-style sharding of the parameters, and
with them Adam's moments, over the mesh's "data" axis, run by FSDP2
(``torch.distributed.fsdp.fully_shard``).

``fsdp_spec`` is JAX's rule: a leaf of at least ``FSDP_MIN_SIZE``
elements is sharded on its largest dimension that the axis divides, and
other leaves stay replicated. FSDP2 shards every parameter it manages, so
a leaf the rule replicates is sharded on dimension 0 instead, unevenly
where the axis does not divide it (FSDP2 pads it); the numbers are the
same either way, only the memory differs.

The tensor-parallel rules (JAX ``partition.py:43-121``) wait for ROADMAP
item 14b.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from torch import nn

from .mesh import DATA_AXIS

FSDP_MIN_SIZE = 16384    # leaves below this stay replicated (the gather
                         # would cost more than the memory it saves)

Spec = Tuple[Optional[str], ...]


def _axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, Mapping):
        return int(mesh[axis])
    return mesh.size(mesh.mesh_dim_names.index(axis))


def fsdp_spec(shape: Tuple[int, ...], mesh: Union[Mapping[str, int], Any],
              axis: str = DATA_AXIS, min_size: int = FSDP_MIN_SIZE) -> Spec:
    """The placement of a leaf of ``shape``, as JAX's PartitionSpec: ``()``
    replicated, else ``axis`` at the sharded dimension and None at the
    others. ``mesh`` is a ``DeviceMesh`` or a mapping of axis sizes."""
    n = _axis_size(mesh, axis)
    if n <= 1 or not shape or math.prod(shape) < min_size:
        return ()
    candidates = [(size, dim) for dim, size in enumerate(shape)
                  if size % n == 0]
    if not candidates:
        return ()
    _, dim = max(candidates)
    return tuple(axis if d == dim else None for d in range(len(shape)))


def fsdp_sharding_tree(tree: Mapping[str, Any],
                       mesh: Union[Mapping[str, int], Any],
                       axis: str = DATA_AXIS,
                       min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """``fsdp_spec`` of every tensor of a state dict (or any mapping of
    names to tensors or shapes), by name."""
    return {name: fsdp_spec(tuple(getattr(leaf, "shape", leaf)), mesh,
                            axis, min_size)
            for name, leaf in tree.items()}


def apply_fsdp(model: nn.Module, mesh, axis: str = DATA_AXIS,
               min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """Shard ``model``'s parameters in place over ``mesh``'s ``axis`` with
    FSDP2, each on the dimension ``fsdp_spec`` picks (0 where it
    replicates); an optimizer built afterwards shards its state with them.
    Every forward gathers the whole parameters first (one group at the
    root), so the kernels see plain tensors, and the gradients are
    reduce-scattered as their mean over the axis. Returns the model."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def placement(param: nn.Parameter) -> Shard:
        spec = fsdp_spec(tuple(param.shape), mesh, axis, min_size)
        return Shard(spec.index(axis) if spec else 0)

    fully_shard(model, mesh=mesh[axis], shard_placement_fn=placement)
    return model
