"""Profiling and debugging hooks: the port's counterpart of the JAX
package's ``utils/profiling.py``, in PyTorch's idiom.

- ``trace(log_dir)``: a ``torch.profiler`` trace of the block (the CPU, and
  the card where there is one) written under ``log_dir`` as a
  Chrome/Perfetto ``*.pt.trace.json``, which TensorBoard's profiler plugin
  reads as it reads JAX's XProf traces;
- ``nan_guard()``: JAX's ``jax_debug_nans`` for a block: the first op
  whose floating-point output holds a NaN raises ``FloatingPointError``
  naming the op, in the forward and in the backward;
- ``StepTimer``: per-step wall-clock times with a device barrier, and their
  summary.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_aten = torch.ops.aten
# ops whose output is memory nobody wrote yet: a NaN there is no result
_UNWRITTEN = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided, _aten.resize_,
              _aten.resize_as_, _aten.set_}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its trace under
    ``log_dir`` on exit, as ``tensorboard_trace_handler`` names it
    (``<host>_<pid>.<ns>.pt.trace.json``). Yields the profiler, whose
    ``key_averages()`` sum the block's events.

    Run one warm-up step before the block: a window that opens on a
    step's first launch has been seen to lose kernel records on the
    card."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def _nan_in(where: str, values: Iterable) -> None:
    for t in values:
        if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                and (t.is_floating_point() or t.is_complex())
                and t.device.type != "meta" and t.numel()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"nan_guard: NaN in the output of "
                                     f"{where}")


def _written(func, args, kwargs, out) -> List:
    """The tensors ``func`` wrote: its results that are not views of an
    input, and the arguments it writes in place (``x.add_(y)``,
    ``out=``, the optimizers' ``_foreach_*_``)."""
    schema = func._schema
    written = []
    results = out if len(schema.returns) > 1 else (out,)
    for ret, value in zip(schema.returns, results):
        if ret.alias_info is None or ret.alias_info.is_write:
            written.append(value)
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            written.append(args[i] if i < len(args)
                           else kwargs.get(arg.name))
    return _pytree.tree_leaves(written)


class _NanGuard(TorchDispatchMode):
    """Checks what every op writes; ``check_launch`` checks what a hand
    kernel launched through ctypes wrote (``kernels.check_launch``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket not in _UNWRITTEN:
            _nan_in(str(func), _written(func, args, kwargs, out))
        return out

    @staticmethod
    def check_launch(name: str, outputs: Iterable) -> None:
        with _disable_current_modes():
            _nan_in(f"the {name} kernel", outputs)


@contextlib.contextmanager
def nan_guard() -> Iterator[None]:
    """Raise ``FloatingPointError`` at the first op (an ``aten`` op, an
    ``mmcsi`` op, or a hand kernel launched through ctypes, K2's and K4's
    backward and K5) whose floating-point output holds a NaN while the
    block runs, naming it. The guard is a ``TorchDispatchMode``: it holds
    for this thread and for the autograd engine's threads that run the
    block's backward, and is gone after the block. Each check reads one
    flag back from the device (one sync an op on the card). Results of a
    block without NaN are bit-equal to the same code outside it."""
    with _NanGuard():
        yield


def _cuda_devices(result) -> set:
    return {t.device for t in _pytree.tree_leaves(result)
            if isinstance(t, torch.Tensor) and t.is_cuda}


class StepTimer:
    """Per-step wall-clock times; with ``sync`` each ``stop(result)`` first
    waits for the devices of the CUDA tensors in ``result`` (a tensor or a
    tree of them), so a step's time includes its device work."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> None:
        if self.sync and result is not None:
            for device in _cuda_devices(result):
                torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(np.median(arr)),
                "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum()), "steps": len(arr)}
