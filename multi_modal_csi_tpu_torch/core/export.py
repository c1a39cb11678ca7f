"""Serving artifacts: the port of the JAX package's ``core/export.py``.

``export_serving`` traces a model's serving forward once with
``torch.export`` and serializes the program. The artifact is
self-contained: the weights are inside, and ``load_serving`` runs it with
no model code, no Python class and no retracing; it needs only the port's
``kernels`` package, which registers the ``mmcsi`` custom ops an artifact
for the card holds (this module imports the model-side code, the serving
cast and the quantizer, only inside ``export_serving``). ``save_artifact`` and ``load_artifact`` wrap the
program in JAX's file format: the ``MMCSI-SERVE\\0`` magic, the length of
a JSON header as 8 little-endian bytes, the header, then the body.

The serving contract is JAX's (``core/export.py:71-107`` there), in its
order: the weights cast once to the serving dtype, then quantized
(``core/quantize.py::quantize_for_serving``, after the cast, so the scales
stay f32), then the input contract (an int8 input is dequantized in the
program, x times ``input_scale`` in the serving dtype; any other input is
cast to the serving dtype in the program), and float32 logits out. The
input's shape and dtype are static: an artifact serves one batch size.

Platforms (JAX's ``flash_mode`` rule, ``:110-114``): an artifact that
may run on the card (platforms with ``"cuda"``) traces the hand kernels
as their ``mmcsi`` ops, even from a CPU host. The ops dispatch by device
when the program runs, the launch on the card and the plain version on
the CPU, so a ``("cuda", "cpu")`` artifact runs on either device and a
CUDA tensor never takes a plain version. A ``("cpu",)`` artifact traces
the forward as the eager CPU server runs it: from a CPU host, the plain
versions as ATen operations. The platforms travel with the program and
``load_serving`` refuses a device they do not name.

cuDNN's TF32 flag is a backend setting that no exported program records,
so ``load_serving`` runs each call inside ``core/device.py::cudnn_f32``:
an f32 artifact's convolutions run in full f32 whatever the caller's
flag, as the eager layers' do.

Each int8 weight is stored once: the layer reads its padded or tap-major
copy (the ``<name>_padded`` or ``<name>_taps`` buffer of
``core/quantize.py::pad_weights``), and before tracing the weight becomes
a view of that copy (of a tap-major one, permuted and cut to its
channels), which is made persistent, so that the serializer writes their
one storage once.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import zipfile
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from ..kernels import ops_everywhere, register_ops
from ..kernels.int8_matmul import tap_major_view
from .device import cudnn_f32, resolve_device

_MAGIC = b"MMCSI-SERVE\x00"
PLATFORMS = ("cuda", "cpu")
_CONTRACT = "mmcsi_contract"      # the program's extra file: JSON
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
Samples = Union[np.ndarray, torch.Tensor]


class _Serving(nn.Module):
    """The serving contract around ``model``: an int8 input times the
    input scale (both in the serving dtype), any other input cast to the
    serving dtype; every output as float32."""

    def __init__(self, model: nn.Module, dtype: Optional[torch.dtype],
                 input_scale: Optional[float]):
        super().__init__()
        self.model, self.dtype = model, dtype
        if input_scale is not None:
            self.register_buffer("input_scale", torch.tensor(
                input_scale, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor):
        if x.dtype == torch.int8:
            x = x.to(self.input_scale.dtype) * self.input_scale
        elif self.dtype is not None:
            x = x.to(self.dtype)
        return torch.utils._pytree.tree_map(lambda o: o.float(),
                                            self.model(x))


def _store_int8_once(model: nn.Module) -> None:
    """Make each int8 weight a view of its padded or tap-major copy, and
    the copy a persistent buffer, so that both name one storage in the
    state dict (``torch.export`` lifts every parameter, even one whose data
    the forward never reads)."""
    for module in model.modules():
        for name, param in list(module.named_parameters(recurse=False)):
            if param.dtype != torch.int8:
                continue
            for suffix in ("_padded", "_taps"):
                stored = getattr(module, f"{name}{suffix}", None)
                if stored is None:
                    continue
                view = (stored[:, :param[0].numel()].view(param.shape)
                        if suffix == "_padded"
                        else tap_major_view(stored, param.shape))
                setattr(module, name, nn.Parameter(view, requires_grad=False))
                module.register_buffer(f"{name}{suffix}", stored,
                                       persistent=True)


def export_serving(model: nn.Module, example_x: Samples, *,
                   serving_dtype: Optional[str] = None,
                   input_dtype: Optional[str] = None,
                   quant: Optional[str] = None,
                   calib_x: Optional[Sequence[Samples]] = None,
                   calib_stat: str = "amax",
                   input_scale: Optional[float] = None,
                   platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Export ``model``'s eval forward as a serving artifact; returns the
    serialized bytes (``save_artifact``, ``load_serving``).

    ``model`` is a port model (not changed: a copy is cast, quantized and
    traced) on the device to trace on; ``example_x`` an array or tensor
    fixing the serving batch's shape. ``serving_dtype``: None or "float32"
    keeps the weights f32, "bfloat16" casts them. ``input_dtype``: the
    dtype the artifact accepts (default: example_x's); "int8" takes the
    host's round(x / input_scale).clip(-127, 127), with ``input_scale``
    given or derived as amax / 127 of ``calib_x``. ``quant``: None, "w8"
    or "w8a8" (``core/quantize.py``), after the cast; "w8a8" needs
    ``calib_x`` (batches of samples), "w8" discovers its layers with a
    zero batch of the example's shape when none is given. ``platforms``:
    a subset of ``PLATFORMS``; with "cuda" the hand kernels are traced as
    ``mmcsi`` ops.
    """
    from ..train.loop import cast_for_serving
    from .quantize import quantize_for_serving
    platforms = tuple(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be taken from {PLATFORMS}, got "
                         f"{platforms}")
    device = next(model.parameters()).device
    model = copy.deepcopy(model).eval().requires_grad_(False)
    dtype = (_DTYPES[serving_dtype]
             if serving_dtype and serving_dtype != "float32" else None)
    if dtype is not None:
        cast_for_serving(model, dtype)
    shape = tuple(example_x.shape)
    if quant:
        if calib_x is None:
            if quant != "w8":
                raise ValueError("w8a8 export needs calib_x batches")
            calib_x = [torch.zeros(shape)]
        batches = [torch.as_tensor(b, dtype=torch.float32).to(device)
                   for b in calib_x]          # fed as given, not cast
        quantize_for_serving(model, batches, mode=quant, stat=calib_stat)
        _store_int8_once(model)
    in_dtype = (_DTYPES[input_dtype] if input_dtype
                else torch.as_tensor(example_x[:0]).dtype)
    if in_dtype == torch.int8:
        if input_scale is None:
            if not calib_x:
                raise ValueError("input_dtype='int8' needs input_scale or "
                                 "calib_x to derive it")
            input_scale = max(max(float(torch.as_tensor(b).abs().max())
                                  for b in calib_x), 1e-12) / 127.0
        input_scale = float(input_scale)
    else:
        input_scale = None
    example = torch.empty(shape, dtype=in_dtype, device=device)
    serving = _Serving(model, dtype, input_scale)
    with (ops_everywhere() if "cuda" in platforms
          else contextlib.nullcontext()):
        program = torch.export.export(serving, (example,), strict=False)
    program.example_inputs = None      # the serializer would store the batch
    contract = {"platforms": list(platforms), "input_shape": list(shape),
                "input_dtype": str(in_dtype).removeprefix("torch.")}
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={_CONTRACT: json.dumps(contract)})
    return buf.getvalue()


def stored_bytes(blob: bytes) -> int:
    """The bytes of the tensors that an artifact stores: the sizes of the
    program archive's weight and constant files (an int8 weight and its
    padded copy, one storage, are one file)."""
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        sizes = [info.file_size for info in archive.infolist()
                 if ("/data/weights/" in info.filename
                     or "/data/constants/" in info.filename)
                 and not info.filename.endswith(".json")]
    if not sizes:
        raise ValueError("the artifact's program archive holds no weight "
                         "files")
    return sum(sizes)


def save_artifact(path: str, blob: bytes, meta: Optional[dict] = None) -> None:
    """Write ``blob`` after the magic and a JSON header of ``meta``
    (model, task, batch, dtypes...)."""
    header = json.dumps(meta or {}).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob)


def load_artifact(path: str) -> Tuple[bytes, dict]:
    """(body, header) of an artifact file; ValueError for another file."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not a serving artifact")
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        return f.read(), meta


def load_serving(blob: bytes, device: Optional[Union[str, torch.device]]
                 = None) -> Callable[[Samples], Any]:
    """Deserialize an artifact into a callable on ``device`` (the card
    unless told otherwise; one of the platforms it was exported for). The
    callable takes one batch of the exported shape and dtype (an array or
    a tensor, on any device; ValueError otherwise) and returns the f32
    logits on ``device``, with cuDNN's f32 convolutions in full f32."""
    register_ops()
    device = resolve_device(device)
    extra = {_CONTRACT: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra)
    contract = json.loads(extra[_CONTRACT])
    if device.type not in contract["platforms"]:
        raise ValueError(f"the artifact was exported for "
                         f"{contract['platforms']}, not {device.type}")
    module = move_to_device_pass(program, device).module()
    shape = tuple(contract["input_shape"])
    dtype = _DTYPES[contract["input_dtype"]]

    def call(x: Samples):
        x = torch.as_tensor(x)
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"the artifact takes {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        with torch.no_grad(), cudnn_f32():
            return module(x.to(device))

    return call


def serve_file(path: str, device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[Callable[[Samples], Any], dict]:
    """``load_serving`` of an artifact file, and its header."""
    blob, meta = load_artifact(path)
    return load_serving(blob, device), meta


def serve_ragged(fn: Callable[[Samples], torch.Tensor], batch: int,
                 axis: Optional[int] = None) -> Callable[[Samples],
                                                         torch.Tensor]:
    """Wrap an artifact's callable (fixed batch ``batch``) to take any
    number of samples: full batches, the remainder zero-padded, the
    outputs' padding cut and the outputs concatenated.

    The output's batch axis is the one axis of length ``batch`` (DETR's
    artifacts return (L, B, Q, C), MLP's (B, C)); where another axis has
    that length too, it raises rather than guess: pass ``axis`` then.
    """
    def call(x: Samples, axis: Optional[int] = axis) -> torch.Tensor:
        x = torch.as_tensor(x)
        outs = []
        for start in range(0, x.shape[0], batch):
            chunk = x[start:start + batch]
            pad = batch - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (pad,) + tuple(chunk.shape[1:]))])
            out = fn(chunk)
            if axis is None:
                axes = [i for i, n in enumerate(out.shape) if n == batch]
                if len(axes) != 1:
                    raise ValueError("cannot identify the batch axis in "
                                     f"output shape {tuple(out.shape)}")
                axis = axes[0]
            if pad:
                out = out.narrow(axis, 0, batch - pad)
            outs.append(out)
        return torch.cat(outs, dim=axis)

    return call
