"""Parameter placement over the mesh (counterpart of the JAX package's
``parallel/partition.py``): the tensor-parallel rules over the "model"
axis, and FSDP over the "data" axis.

Tensor parallelism. ``DEFAULT_TP_RULES`` are JAX's rules (``partition.py:
43-121`` there) on the port's parameter names, which follow the
reference's torch layout: a JAX ``kernel`` (in, out) is a torch
``weight`` (out, in), so JAX's column-parallel ``P(None, "model")`` is
dimension 0 of the port's weight, and its row-parallel ``P("model",
None)`` dimension 1:

- attention (``nn/layers.py::MultiheadAttention``): ``in_proj_weight``
  column-parallel, ``out_proj.weight`` row-parallel;
- DETR's and THAT_ENCODER's decoder FFN: ``ffn.0`` column, ``ffn.3`` row;
- the video attention backbones (Swin3D, MViT): ``attn.qkv`` column,
  ``attn.proj`` (Swin3D) and ``attn.project.0`` (MViT) row, ``mlp.0``
  column, ``mlp.3`` row; MViT's block-level residual ``project`` stays
  replicated, as JAX's ``attn/`` anchor keeps it;
- the conv and recurrent families match no rule and replicate.

As in JAX, a rule applies only where the axis divides the dimension it
shards; the first matching rule wins; everything else is replicated. A
column-parallel weight's bias is sharded with its rows (JAX leaves the
bias whole and lets GSPMD slice it); a row-parallel weight's bias stays
whole and is added once, after the sum over the axis.

``apply_tensor_parallel`` places each sharded parameter as this rank's
shard, a DTensor on the mesh's "model" axis (``distribute_tensor``), so
that ``full_tensor`` (here; ``train/loop.py::state_snapshot``) gathers
it whole,
and tells the modules the rules touch to run on their shards (the
modules' forwards use ``to_local()``, because the hand kernels take plain
tensors). A packed q/k/v weight, (3e, e), is not head-aligned under a
plain ``Shard(0)`` (it would put all of q and half of k on rank 0): each
of q, k and v has its ``e`` rows split over the axis instead
(``_StridedShard`` with a split factor of 3), so rank r holds
[q_r; k_r; v_r], the heads it computes. The spec table (``partition_
specs``) still says dimension 0, as JAX's does.

Neither JAX's ``fit`` nor ``fit_video`` applies the rules (both replicate
over "model"); they are reached through ``apply_tensor_parallel`` and
``entry.py::dryrun_multichip``.

FSDP: ZeRO-3-style sharding of the parameters, and with them Adam's
moments, over the mesh's "data" axis, run by FSDP2
(``torch.distributed.fsdp.fully_shard``).

``fsdp_spec`` is JAX's rule: a leaf of at least ``FSDP_MIN_SIZE``
elements is sharded on its largest dimension that the axis divides, and
other leaves stay replicated. FSDP2 shards every parameter it manages, so
a leaf the rule replicates is sharded on dimension 0 instead, unevenly
where the axis does not divide it (FSDP2 pads it); the numbers are the
same either way, only the memory differs.

"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS

FSDP_MIN_SIZE = 16384    # leaves below this stay replicated (the gather
                         # would cost more than the memory it saves)

Spec = Tuple[Optional[str], ...]


def _axis_size(mesh, axis: str) -> int:
    if isinstance(mesh, Mapping):
        return int(mesh[axis])
    return mesh.size(mesh.mesh_dim_names.index(axis))


# (name regex, sharded dimension of the port's tensor): first match wins,
# default replicated. Dimension 0 is JAX's P(None, "model") on the kernel
# (column-parallel), dimension 1 its P("model", None) (row-parallel).
DEFAULT_TP_RULES: Sequence[Tuple[str, int]] = (
    # attention (nn/layers.py::MultiheadAttention) and the decoder FFN
    (r".*in_proj_weight$", 0),
    (r".*out_proj\.weight$", 1),
    (r".*ffn\.0\.weight$", 0),
    (r".*ffn\.3\.weight$", 1),
    # the video attention backbones (models/video/swin3d.py, mvit.py)
    (r".*attn\.qkv\.weight$", 0),
    (r".*attn\.(proj|project\.0)\.weight$", 1),
    (r".*mlp\.0\.weight$", 0),
    (r".*mlp\.3\.weight$", 1),
)
# a column-parallel weight's bias, sharded with its rows
_COLUMN_BIAS = re.compile(r"(.*)(in_proj_bias|\.bias)$")
# the packed q/k/v tensors: each third split over the axis on its own
_PACKED = re.compile(r".*(in_proj_(weight|bias)|attn\.qkv\.(weight|bias))$")
PACKED_SPLIT = 3


def spec_for_path(path: str, shape: Tuple[int, ...],
                  mesh: Union[Mapping[str, int], Any],
                  axis: str = MODEL_AXIS) -> Spec:
    """The placement of the parameter ``path`` of ``shape`` by the first
    rule of ``DEFAULT_TP_RULES`` whose pattern matches it and whose
    dimension the axis divides (JAX's ``spec_for_path``): ``axis`` at that
    dimension and None at the others, ``()`` replicated."""
    n = _axis_size(mesh, axis)
    for pattern, dim in DEFAULT_TP_RULES:
        if re.match(pattern, path):
            if dim < len(shape) and shape[dim] % n == 0:
                return tuple(axis if d == dim else None
                             for d in range(len(shape)))
    return ()


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: tuple(getattr(p, "shape", p)) for name, p in params.items()}


def partition_specs(params, mesh: Union[Mapping[str, int], Any]
                    ) -> Dict[str, Spec]:
    """The placement of every parameter of ``params`` (a module, or a
    mapping of names to tensors or shapes) by the rules, by name: JAX's
    ``partition_specs`` transposed to the port's layout, and a
    column-parallel weight's bias sharded with it. ``mesh`` is a
    ``DeviceMesh`` or a mapping of axis sizes."""
    shapes = _shapes(params)
    specs = {name: spec_for_path(name, shape, mesh)
             for name, shape in shapes.items()}
    for name, shape in shapes.items():
        bias = _COLUMN_BIAS.match(name)
        if bias is None or len(shape) != 1:
            continue
        weight = bias.group(1) + (
            "in_proj_weight" if bias.group(2) == "in_proj_bias" else
            ".weight")
        if specs.get(weight, ())[:1] == (MODEL_AXIS,):
            specs[name] = (MODEL_AXIS,)
    return specs


def _placement(name: str, spec: Spec):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if MODEL_AXIS not in spec:
        return Replicate()
    dim = spec.index(MODEL_AXIS)
    if _PACKED.match(name):
        return _StridedShard(dim, split_factor=PACKED_SPLIT)
    return Shard(dim)


def sharding_tree(params, mesh) -> Dict[str, Any]:
    """The DTensor placement on the mesh's "model" axis of every parameter
    (JAX's ``sharding_tree``), by name: ``Shard(dim)``, the packed q/k/v
    tensors' ``_StridedShard`` (each third split on its own), or
    ``Replicate()``."""
    return {name: _placement(name, spec)
            for name, spec in partition_specs(params, mesh).items()}


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (every rank of its mesh calls this
    alike; a plain tensor as it is). A packed q/k/v placement
    (``_StridedShard``), which some PyTorch versions cannot redistribute
    (2.11's ``full_tensor`` refuses it), is all-gathered over its axis
    and each third put back together; other placements take
    ``DTensor.full_tensor``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard
    if not isinstance(t, DTensor):
        return t
    placement = t.placements[0]
    if len(t.placements) != 1 or not isinstance(placement, _StridedShard):
        return t.full_tensor()
    group = t.device_mesh.get_group()
    local = t.to_local().contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(
        group))]
    dist.all_gather(parts, local, group=group)
    dim, split = placement.dim, placement.split_factor
    pieces = [part.chunk(split, dim) for part in parts]
    return torch.cat([torch.cat([p[i] for p in pieces], dim)
                      for i in range(split)], dim)


def shard_params(model: nn.Module, mesh) -> Dict[str, Spec]:
    """Place ``model``'s parameters in place by the rules: each sharded
    one becomes a DTensor holding this rank's shard on the mesh's "model"
    axis, the others stay as they are. Returns the specs."""
    from torch.distributed.tensor import distribute_tensor
    specs = partition_specs(model, mesh)
    placements = sharding_tree(model, mesh)
    model_mesh = mesh[MODEL_AXIS]
    for name, param in list(model.named_parameters()):
        if MODEL_AXIS not in specs[name]:
            continue
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        placed = distribute_tensor(param.detach(), model_mesh,
                                   [placements[name]])
        setattr(module, attr, nn.Parameter(placed,
                                           requires_grad=param.requires_grad))
    return specs


def apply_tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` in place over ``mesh``'s "model" axis by the rules
    (``shard_params``) and set the modules they touch to run on this
    rank's shards (``model_shards``, read inside ``axis_scope`` of the
    mesh): attention on its heads (or, where the axis does not divide the
    heads, on q, k and v gathered over the axis, then the output
    projection on this rank's columns), column-parallel Linears on their
    rows, row-parallel ones on their columns with the sum over the axis,
    and the dropouts between a column and a row Linear on their columns.
    The pairs are the ones each module declares
    (``TENSOR_PARALLEL_PAIRS``: column weight, row weight). A rule that
    shards one side of a pair and not the other, a packed q/k/v whose
    thirds the axis does not divide (the port's forwards compute from
    head-aligned shards; JAX's GSPMD would redistribute), and an int8
    model (int8 serving is not combined with the rules, in JAX either)
    raise ValueError. Returns the model."""
    from ..nn.layers import Dropout, Linear
    size = _axis_size(mesh, MODEL_AXIS)
    shapes = _shapes(model)
    specs = partition_specs(shapes, mesh)
    sharded = {name for name, spec in specs.items() if MODEL_AXIS in spec}
    if any(p.dtype == torch.int8 for p in model.parameters()):
        raise ValueError("the tensor-parallel rules take a float model, not "
                         "an int8 one")
    for name in sharded:
        if _PACKED.match(name) and (shapes[name][0] // PACKED_SPLIT) % size:
            raise ValueError(f"{name}: the model axis of {size} does not "
                             f"divide each third of the packed q/k/v")
    for prefix, module in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        pairs = getattr(module, "TENSOR_PARALLEL_PAIRS", ())
        for column, row in pairs:
            ends = [f"{pre}{column}" in sharded, f"{pre}{row}" in sharded]
            if any(ends) and not all(ends):
                raise ValueError(f"{pre}{column} and {pre}{row}: the rules "
                                 f"shard one and not the other")
            if all(ends):
                module.model_shards = size
        if isinstance(module, Linear) and f"{pre}weight" in sharded:
            module.parallel = ("column" if specs[f"{pre}weight"][0]
                               == MODEL_AXIS else "row")
    for module in model.modules():
        if isinstance(module, nn.Sequential):
            column = False
            for layer in module:
                role = getattr(layer, "parallel", None)
                if role is not None:
                    column = role == "column"
                elif isinstance(layer, Dropout) and column:
                    layer.model_dim = -1
    shard_params(model, mesh)
    return model


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
