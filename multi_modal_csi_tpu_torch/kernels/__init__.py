"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper counts its launches in ``LAUNCH_COUNTS`` (kernel name -> number
of launches since the last ``reset_launch_counts()``), adding one only where
it launches its CUDA kernel, so a run can show that its main path went
through the kernels.

The kernels that a serving forward launches are ``torch.library`` ops in
the ``mmcsi`` namespace (``mmcsi::flash_attention``,
``mmcsi::flash_attention_lowrank_bias``, ``mmcsi::quantized_product``,
``mmcsi::quantized_conv3d``, ``mmcsi::quantize_columns``,
``mmcsi::quantize_columns3d``), each defined
by ``define_op``: its CUDA implementation is the launch, its CPU
implementation the plain version, and a fake implementation gives the
output's shape and dtype, so that ``torch.export`` traces it as one
node. A wrapper's CUDA branch
calls its op, so eager serving and an exported program run the same code.
Importing the kernel modules registers the ops (``register_ops``).

``ops_everywhere`` makes the wrappers call their op on tensors of any
device while a block runs (JAX's ``flash_mode``), so that an export for
the card keeps the kernels even when it is traced on the CPU: the ops
dispatch by device when the program runs, the launch on the card and the
plain version on the CPU. Outside it a wrapper calls its op on CUDA
tensors and its plain version on CPU tensors; a CUDA tensor never takes a
plain version.

``check_launch`` shows what a kernel launched through ctypes outside an
op (K2's and K4's backward, K5) wrote to an active ``nan_guard``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterable, Iterator

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

LAUNCH_COUNTS: Dict[str, int] = {}
_LIBRARY = torch.library.Library("mmcsi", "DEF")
_OPS_EVERYWHERE = contextvars.ContextVar("mmcsi_ops_everywhere",
                                         default=False)


def count_launch(name: str) -> None:
    LAUNCH_COUNTS[name] = LAUNCH_COUNTS.get(name, 0) + 1


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def check_launch(name: str, outputs: Iterable[torch.Tensor]) -> None:
    """Hand the tensors a launch through ctypes wrote to each active
    dispatch mode that checks them (``utils/profiling.py::nan_guard``):
    such a launch is no op the dispatcher sees."""
    for mode in _get_current_dispatch_mode_stack():
        check = getattr(mode, "check_launch", None)
        if check is not None:
            check(name, outputs)


@contextlib.contextmanager
def ops_everywhere() -> Iterator[None]:
    """Make the wrappers call their op on tensors of any device while the
    block runs."""
    token = _OPS_EVERYWHERE.set(True)
    try:
        yield
    finally:
        _OPS_EVERYWHERE.reset(token)


def uses_op(device: torch.device) -> bool:
    """Whether a wrapper given tensors on ``device`` calls its custom op
    (the kernel on the card) rather than its plain version."""
    return device.type == "cuda" or _OPS_EVERYWHERE.get()


def define_op(schema: str, cuda: Callable, cpu: Callable,
              fake: Callable) -> None:
    """Define the op ``mmcsi::<schema>`` with its CUDA implementation (the
    launch), its CPU implementation (the plain version) and its fake
    implementation (the output's shape and dtype). The op is registered
    with the dispatcher directly: ``torch.library.custom_op`` adds a
    Python autograd layer and a compiler guard to every call, host time
    an eager forward of a hundred launches pays each time."""
    name = schema.split("(", 1)[0]
    _LIBRARY.define(schema)
    _LIBRARY.impl(name, cuda, "CUDA")
    _LIBRARY.impl(name, cpu, "CPU")
    torch.library.register_fake(f"mmcsi::{name}", fake, lib=_LIBRARY)


def register_ops() -> None:
    """Import the kernel modules, which register the ``mmcsi`` ops (a
    loaded exported program needs them before it is deserialized)."""
    from . import flash_attention, flash_attention_lowrank, int8_matmul  # noqa: F401
