"""Process groups and the device mesh (counterpart of the JAX package's
``parallel/mesh.py``) over ``torch.distributed``.

One process ("rank") drives one device, as ``torchrun`` launches them. The
mesh names its axes ("data", "model"). A global batch splits over "data";
ranks along "model" take the same rows, as JAX's batch sharding
replicates over "model". ``fit`` and ``fit_video`` replicate the model
over that axis, as JAX's do; the tensor-parallel rules that split it
there are reached through ``parallel/partition.py::apply_tensor_parallel``
and ``entry.py::dryrun_multichip``.

- ``initialize_distributed``: the default process group, NCCL on the card
  and gloo only when the caller asks for the CPU; ``local_device``: the
  card torchrun gave this process; ``one_rank_group``: a group of this
  process alone, joined as torchrun would describe it;
- ``create_mesh``: a ``DeviceMesh`` named ("data", "model") over every
  rank;
- ``BatchSharding`` (``batch_sharding``, ``config_batch_sharding``): a
  rank's rows of a global batch; ``batch_divisor`` and ``shard_batch``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket
from typing import Dict, Iterator, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _backend(device: Union[str, torch.device]) -> str:
    kind = torch.device(device).type
    if kind == "cpu":
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"no process-group backend for device {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run data-parallel on the CPU (gloo)")
    if not dist.is_nccl_available():
        raise RuntimeError("this PyTorch has no NCCL: data-parallel runs on "
                           "the card need it (gloo is taken only for "
                           "device='cpu')")
    return "nccl"


def local_device() -> int:
    """The card torchrun gave this process: ``LOCAL_RANK``, its rank among
    the ranks of its node (0 outside torchrun). Never the global
    ``RANK``: on the second node of a multi-node run it counts past the
    node's cards."""
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(num_processes: Optional[int] = None, *,
                           device: Union[str, torch.device] = "cuda"
                           ) -> None:
    """Join the default process group that ``torchrun`` describes in the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``): NCCL for ``device`` "cuda" (the card;
    raises where NCCL or the card is missing), gloo for "cpu". Does
    nothing where that environment is absent (a single process) or for
    ``num_processes=1``. Idempotent. On the card the process takes device
    ``local_device()`` before anything runs there."""
    if (num_processes == 1 or dist.is_initialized()
            or "WORLD_SIZE" not in os.environ):
        return
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend, init_method="env://")


def free_port() -> int:
    """A free TCP port on this machine (a group's address is localhost)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(device: Union[str, torch.device] = "cuda"
                   ) -> Iterator[None]:
    """A process group of this process alone (NCCL on the card, gloo for
    the CPU), joined through ``initialize_distributed`` with torchrun's
    environment for one rank on a free local port; the group is left and
    the environment restored when the block ends."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    before = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize_distributed(device=device)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that prints and
    writes a run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if dist.is_initialized():
        dist.barrier()


def create_mesh(axis_sizes: Optional[Dict[str, int]] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the default group, on the
    group's device (the card under NCCL, the CPU under gloo), with named
    axes, ("data", "model") by default: every rank on "data".
    ``axis_sizes``, e.g. {"data": 2, "model": 2}, must multiply to the
    world size; rank r sits at the row-major coordinate of r."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "initialize_distributed first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: n, MODEL_AXIS: 1}
    sizes = tuple(int(s) for s in axis_sizes.values())
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} processes")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, sizes,
                            mesh_dim_names=tuple(axis_sizes))


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Axis 0 of every global batch split ``size`` ways over the mesh's
    "data" axis, replicated over its other axes; this rank holds part
    ``index``. ``mesh`` is None only for a record built by hand."""
    mesh: Optional[DeviceMesh]
    size: int
    index: int

    @property
    def group(self) -> dist.ProcessGroup:
        """The process group along "data" through this rank."""
        return self.mesh.get_group(DATA_AXIS)

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a global batch of ``n`` rows
        (JAX's ``data/pipeline.py::_local_rows``); ranks that differ only
        along other axes take the same rows. A batch the axis does not
        divide is refused."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over a data axis of {self.size}: make the "
                             f"batch a multiple of it")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: DeviceMesh) -> BatchSharding:
    """Split the batch (axis 0) over "data"; replicate the rest."""
    dim = mesh.mesh_dim_names.index(DATA_AXIS)
    return BatchSharding(mesh, mesh.size(dim),
                         mesh.get_local_rank(DATA_AXIS))


def config_batch_sharding(cfg, device: Union[str, torch.device] = "cuda"
                          ) -> Optional[BatchSharding]:
    """Batch sharding over the config's resolved mesh (``cfg.mesh``,
    ``core/config.py::MeshConfig``); None for a single process, as the
    JAX package returns None on one device. Shared by both runners'
    ``use_mesh``. Raises where the group's backend cannot carry tensors
    of ``device`` (never falls back to gloo or the CPU), and where
    torchrun started several processes but none joined a group (each
    would train alone on the whole data set)."""
    backend = _backend(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            raise RuntimeError(
                "torchrun started this process as one of "
                f"{os.environ['WORLD_SIZE']}, but no process group was "
                "joined: pass --distributed (or call "
                "initialize_distributed) before using the mesh")
        return None
    if dist.get_world_size() <= 1:
        return None
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"but device {torch.device(device).type!r} "
                           f"needs {backend}")
    axes = cfg.mesh.resolved(dist.get_world_size())
    return batch_sharding(create_mesh(axes))


def batch_divisor(sharding: Optional[BatchSharding]) -> int:
    """How many ways ``sharding`` splits a batch: a global batch, and an
    evaluation chunk padded up to one, must be a multiple of it."""
    return 1 if sharding is None else sharding.size


def shard_batch(sharding: Optional[BatchSharding], *arrays, axis: int = 0):
    """This rank's rows (``BatchSharding.rows``) of each global batch in
    ``arrays`` along ``axis`` (1 for an epoch's index matrix); the arrays
    as they are without a sharding."""
    out = arrays
    if sharding is not None:
        lead = (slice(None),) * axis
        out = tuple(a[lead + (sharding.rows(a.shape[axis]),)]
                    for a in arrays)
    return out if len(out) > 1 else out[0]
