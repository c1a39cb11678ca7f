"""Post-training int8 quantization for serving: the port of the JAX
package's ``core/quantize.py``.

Two modes, as there:

- ``"w8"`` (weight-only): a hooked layer's weight is stored int8 with a
  per-output-channel ``weight_scale`` buffer beside it; the layer multiplies
  the bf16 activation by the dequantised bf16 weight with f32 accumulation
  and applies the scale to the f32 product.
- ``"w8a8"``: additionally an ``input_scale`` buffer (a per-tensor scale
  from calibration) per hooked layer; the layer quantizes its input to int8
  and the product runs int8 x int8 -> int32, rescaled by
  ``weight_scale * input_scale``.

There is no mode flag: an int8 weight is the signal, and an
``input_scale`` buffer beside it selects w8a8. A layer's product runs in
``kernels/int8_matmul.py`` as two launches on the card: the prologue
(``quantize_columns``: the activation quantized, or cast to bf16, and
unfolded for a 1-D conv, at a padded row stride) and the product with the
rescale, the bias and the cast in its epilogue. A Linear or a 1-D conv
takes ``quantized_product``, which reads each int8 weight as (out, in)
rows, a conv's (out, C k), padded to a 16-byte row stride: a
non-persistent ``<name>_padded`` buffer beside it, made once when the
model is quantized or loaded, so the state dict stays as it is.

A 2-D or 3-D conv (``conv_nd_forward``) is routed by its channels C:

- C >= ``IMPLICIT_MIN_CHANNELS`` (16; every conv of ResNet3D and S3D but
  their stems, CNN-2D's stages 1 and 2): the prologue at k = 1 quantizes
  the activation once into channels-last codes (B T H W, Cp), C padded
  with zeros to a multiple of 16 bytes (a bf16 activation whose channels
  are a multiple of 8 is read as it is in w8), and ``quantized_conv3d``,
  one launch over the whole batch, reads the conv window from the codes
  itself, as XLA fuses the windows of JAX's ``conv_general_dilated`` on
  the codes: no columns are written. Its weight is the tap-major copy
  (N, kt kh kw Cp), the non-persistent ``<name>_taps`` buffer, made as
  the padded one is;
- C < 16 (the stems' C = 3): ``quantize_columns3d`` writes the (B To Ho
  Wo, C kt kh kw) columns, over chunks of whole samples whose columns fit
  in ``COLUMN_BUDGET`` bytes (ResNet3D's stem writes 63 MB of int8
  columns a (45, 112, 112) clip), each chunk's then ``quantized_product``.

Which layers are quantized is decided by discovery, as in JAX: ``Linear``,
``Conv1d``, ``Conv2d`` and the hooked ``Conv3d`` (``nn/layers.py``:
ResNet3D's and S3D's, JAX's ``Conv3D`` wrapper) record their input's
max-abs (or its 99.9th percentile) while a calibration is recording, and
``MultiheadAttention`` announces its packed ``in_proj_weight`` and
``out_proj.weight`` as weight-only (cross-attention feeds two inputs, so
no per-tensor activation scale applies; ``out_proj`` never records an
input). An unhooked ``Conv3d`` never announces itself, as JAX's MViT and
Swin convs are raw ``nn.Conv``: a layer that never announced can never be
turned int8.

Symmetric quantization (zero-point 0) keeps conv zero-padding exact.

Usage:
    stats = calibrate(model, batches)          # eval mode, batches on device
    quantize_model(model, stats, mode="w8a8")  # in place

or ``quantize_for_serving(model, batches, mode)``. State-dict names follow
the JAX leaves mapped onto the reference layout: ``kernel`` -> ``weight``,
``kernel_scale`` -> ``weight_scale``, ``input_scale``,
``in_proj_weight_scale``, ``out_proj_weight_scale`` ->
``out_proj.weight_scale``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch
from torch import nn

from ..kernels.int8_matmul import (IMPLICIT_MIN_CHANNELS, ROW_ALIGN,
                                   conv3d_output, direct_operand,
                                   pad_columns, padded_width,
                                   quantize_columns, quantize_columns3d,
                                   quantized_conv3d, quantized_product,
                                   tap_major)
# the activation quantizer lives beside the prologue that fuses it; it is
# part of this module's interface, as in the JAX package
from ..kernels.int8_matmul import quantize_activation  # noqa: F401

# weights smaller than this stay float: tiny layers save nothing and lose
# the most precision (10-class heads)
DEFAULT_MIN_WEIGHT_SIZE = 16384
MODES = ("w8", "w8a8")
STATS = ("amax", "p999")
# bytes of a narrow 2-D or 3-D conv's columns written at once: whole
# samples a chunk, so ResNet3D's stem over its serving batch of 64 (45,
# 112, 112) clips, 4.0 GB of columns, runs in chunks of 33 clips
COLUMN_BUDGET = 2 * 2 ** 30

Stats = Dict[str, Optional[float]]
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


# ---------------------------------------------------------------------- #
# tensor-level quantization
# ---------------------------------------------------------------------- #

def quantize_array(w: torch.Tensor, channel_axis: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: (q, scale) with w ~ q * scale.

    ``channel_axis`` is the output-channel axis, 0 for the port's (out,
    ...) weights; ``scale`` (float32) has its length. scale = max(amax,
    1e-12) / 127 and q = clip(round(w / scale), -127, 127), rounding half
    to even, in float32 as JAX's ``quantize_params`` computes it under
    ``jit``, where XLA turns the division by the constant 127 into a
    product with its float32 reciprocal.
    """
    w = w.detach().float()
    axis = channel_axis % w.dim()
    others = tuple(i for i in range(w.dim()) if i != axis)
    amax = w.abs().amax(dim=others) if others else w.abs()
    scale = torch.clamp_min(amax, 1e-12) * _INV_127
    shape = [1] * w.dim()
    shape[axis] = -1
    q = torch.round(w / scale.reshape(shape)).clamp(-127, 127)
    return q.to(torch.int8), scale


def p999(x: torch.Tensor) -> torch.Tensor:
    """The 99.9th percentile of |x| over all elements, as float32, with
    ``jnp.quantile``'s default linear interpolation and its float32
    position arithmetic. ``torch.quantile`` refuses inputs above 2^24
    elements, so the two order statistics come from ``topk``."""
    ax = x.detach().abs().float().reshape(-1)
    n = ax.numel()
    nf = torch.tensor(float(n), dtype=torch.float32)
    pos = torch.tensor(0.999, dtype=torch.float32) * (nf - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo, hi = (int(torch.clamp(t, 0, n - 1)) for t in (low, high))
    top = torch.topk(ax, n - lo, sorted=True).values   # descending
    return (top[n - lo - 1] * w_low.to(ax.device)
            + top[n - hi - 1] * w_high.to(ax.device))


# ---------------------------------------------------------------------- #
# the products of a quantized layer (called from nn/layers.py)
# ---------------------------------------------------------------------- #

def dense_forward(x: torch.Tensor, weight: torch.Tensor,
                  weight_scale: torch.Tensor,
                  input_scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.float32,
                  padded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ dequant(weight)^T + bias as ``out_dtype`` for an int8 (out, in)
    weight (``padded``: the same weight at the product's padded stride).
    w8a8 quantizes x; w8 takes x as bf16, straight from x when the product
    can read it as it is."""
    c = x.shape[-1]
    a = direct_operand(x) if input_scale is None else None
    if a is None:                      # x as (B, L, C), viewed if it can be
        x3 = x.reshape(-1, *x.shape[-2:]) if x.dim() > 2 else x.reshape(
            1, -1, c)
        a = quantize_columns(x3, input_scale)
    y = quantized_product(a, pad_columns(weight) if padded is None
                          else padded, weight_scale, input_scale, bias,
                          out_dtype, k=c)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def conv_forward(x: torch.Tensor, weight: torch.Tensor,
                 weight_scale: torch.Tensor,
                 input_scale: Optional[torch.Tensor], *,
                 pads: Tuple[int, int], stride: int, dilation: int,
                 groups: int, bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.float32,
                 padded: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 1-D convolution of channels-last x (B, L, C) with an int8 weight
    (N, C/groups, k), plus the bias, as ``out_dtype`` (B, L_out, N): the
    padded input (int8 for w8a8, bf16 for w8) unfolded into (B L_out, G,
    C/groups k) columns in the weight's (channel, tap) order, one product
    per group. ``padded``: the weight as (N, C/groups k) at the product's
    padded stride."""
    n, cg, k = weight.shape
    a = quantize_columns(x, input_scale, k, stride, dilation, pads, groups)
    b = pad_columns(weight.reshape(n, cg * k)) if padded is None else padded
    if groups > 1:
        b = b.reshape(groups, n // groups, b.shape[-1])
    y = quantized_product(a, b, weight_scale, input_scale, bias, out_dtype,
                          k=cg * k)
    return y.reshape(x.shape[0], -1, n)


def conv_nd_forward(x: torch.Tensor, weight: torch.Tensor,
                    weight_scale: torch.Tensor,
                    input_scale: Optional[torch.Tensor], *,
                    stride: Tuple[int, int, int],
                    padding: Tuple[int, int, int],
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.float32,
                    padded: Optional[torch.Tensor] = None,
                    taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 3-D convolution of channels-last x (B, T, H, W, C) with an int8
    weight (N, C, kt, kh, kw), symmetric zero ``padding``, plus the bias,
    as ``out_dtype`` (B, To, Ho, Wo, N); a 2-D conv is its kt = 1 case on
    frames of T = 1. JAX's ``lax.conv_general_dilated`` on int8 codes (w8a8)
    or bf16 values (w8). Routed by C (the module docstring says why):

    - C >= IMPLICIT_MIN_CHANNELS: the codes (``conv_codes``) and one
      ``quantized_conv3d`` over the batch, against ``taps``, the weight's
      tap-major copy at the codes' width (``pad_weights``; made here when
      not given);
    - else the input's columns in the weight's (channel, kt, kh, kw) order
      (int8 for w8a8, bf16 for w8) and one product, the columns of
      ``COLUMN_BUDGET`` bytes at most written at a time, a chunk of whole
      samples (at least one); the chunks' products are concatenated.
      ``padded``: the weight as (N, C kt kh kw) at the product's padded
      stride.
    """
    n = weight.shape[0]
    kernel = tuple(weight.shape[2:])
    if x.shape[-1] >= IMPLICIT_MIN_CHANNELS:
        a = conv_codes(x, input_scale)
        if taps is None:
            taps = tap_major(weight, a.shape[-1])
        return quantized_conv3d(a, taps, weight_scale, input_scale, bias,
                                out_dtype, kernel, stride, padding)
    k = weight[0].numel()
    dims = conv3d_output(tuple(x.shape[1:4]), kernel, stride, padding)
    col_dtype = torch.bfloat16 if input_scale is None else torch.int8
    sample = math.prod(dims) * padded_width(k, col_dtype) * col_dtype.itemsize
    step = max(1, COLUMN_BUDGET // sample)
    b = pad_columns(weight.reshape(n, k)) if padded is None else padded
    outs = []
    for start in range(0, x.shape[0], step):
        a = quantize_columns3d(x[start:start + step], input_scale, kernel,
                               stride, padding)
        outs.append(quantized_product(a, b, weight_scale, input_scale, bias,
                                      out_dtype, k=k))
    y = outs[0] if len(outs) == 1 else torch.cat(outs)
    return y.reshape(x.shape[0], *dims, n)


def conv_codes(x: torch.Tensor, input_scale: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """The implicit conv's A from channels-last x (B, T, H, W, C): the
    prologue at k = 1 of its (B, T H W, C) view, int8 codes (w8a8) or bf16
    values (w8) zero-padded to Cp = ``padded_width(C)``, as (B, T, H, W,
    Cp); for w8, a contiguous bf16 x whose rows and base the kernel's
    16-byte copies divide, as it is."""
    c = x.shape[-1]
    if (input_scale is None and x.dtype == torch.bfloat16
            and x.is_contiguous() and (c * 2) % ROW_ALIGN == 0
            and (x.storage_offset() * 2) % ROW_ALIGN == 0):
        return x
    a = quantize_columns(x.reshape(x.shape[0], -1, c), input_scale)
    return a.reshape(*x.shape[:-1], a.shape[-1])


def pad_weights(model: nn.Module) -> nn.Module:
    """Give every int8 weight of ``model`` its product's copy, a
    non-persistent buffer, so that no call makes it again: a 2-D or 3-D
    conv of C >= IMPLICIT_MIN_CHANNELS its ``<name>_taps`` (``tap_major``
    at the width of its codes: int8 where the module has an
    ``input_scale``, w8a8, else bf16), every other its ``<name>_padded``
    (the weight as (out, in) rows, a conv's (out, C k), (out, C kh kw) or
    (out, C kt kh kw), zero-padded to the product's 16-byte stride).
    Returns ``model``."""
    for module in model.modules():
        for name, param in module.named_parameters(recurse=False):
            if param.dtype != torch.int8:
                continue
            w = param.detach()
            if w.dim() in (4, 5) and w.shape[1] >= IMPLICIT_MIN_CHANNELS:
                codes = (torch.int8 if hasattr(module, "input_scale")
                         else torch.bfloat16)
                module.register_buffer(
                    f"{name}_taps",
                    tap_major(w, padded_width(w.shape[1], codes)),
                    persistent=False)
            else:
                module.register_buffer(
                    f"{name}_padded", pad_columns(w.reshape(w.shape[0], -1)),
                    persistent=False)
    return model


# ---------------------------------------------------------------------- #
# calibration (and discovery of the hooked layers)
# ---------------------------------------------------------------------- #

class _Recording:
    """The statistic being recorded and, per announcing module, its
    running maximum (a device scalar) or None for weight-only params."""

    def __init__(self, stat: str):
        self.stat = stat
        self.inputs: Dict[nn.Module, torch.Tensor] = {}
        self.weight_only: Dict[nn.Module, Tuple[str, ...]] = {}


_RECORDING: Optional[_Recording] = None


@contextlib.contextmanager
def recording(stat: str = "amax") -> Iterator[_Recording]:
    """While the block runs, hooked layers record their inputs' ``stat``
    and MultiheadAttention announces its weight-only params."""
    global _RECORDING
    if stat not in STATS:
        raise ValueError(f"unknown calibration stat {stat!r}")
    previous, _RECORDING = _RECORDING, _Recording(stat)
    try:
        yield _RECORDING
    finally:
        _RECORDING = previous


def record_input(module: nn.Module, x: torch.Tensor) -> None:
    """A hooked layer announces itself; under ``recording`` it adds its
    input's statistic to the running maximum. A no-op otherwise."""
    rec = _RECORDING
    if rec is None:
        return
    value = (x.detach().abs().amax().float() if rec.stat == "amax"
             else p999(x))
    old = rec.inputs.get(module)
    rec.inputs[module] = value if old is None else torch.maximum(old, value)


def mark_weight_only(module: nn.Module, *names: str) -> None:
    """Announce ``module``'s params ``names`` (dotted, relative to it) as
    weight-only quantizable: int8 and a ``<name>_scale`` buffer under every
    mode, never an ``input_scale``."""
    if _RECORDING is not None:
        _RECORDING.weight_only[module] = names


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              stat: str = "amax") -> Stats:
    """Run ``batches`` through ``model`` (as given: device, dtype and mode
    are the caller's) while recording; return per hooked weight, by its
    name in ``model``, the running maximum over batches (and over the
    layer's calls) of its input's ``stat`` as a Python float, or None for a
    weight-only param. One batch suffices for w8, where only the names
    matter. A module shared at several places (the weight-shared decoder
    layer) is named once."""
    names = {module: name for name, module in model.named_modules()}
    with recording(stat) as rec:
        for batch in batches:
            model(batch)
    stats: Stats = {}
    for module, value in rec.inputs.items():
        stats[_join(names[module], "weight")] = float(value)
    for module, params in rec.weight_only.items():
        for param in params:
            stats.setdefault(_join(names[module], param), None)
    for name in stats:
        if model.get_parameter(name).dim() < 2:
            raise ValueError(f"hooked parameter {name} is not a weight")
    return stats


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


@torch.no_grad()
def quantize_model(model: nn.Module, stats: Stats, mode: str = "w8",
                   min_size: int = DEFAULT_MIN_WEIGHT_SIZE) -> nn.Module:
    """Quantize, in place, the weights that ``calibrate`` found: each float
    weight of at least ``min_size`` elements becomes an int8 parameter
    (``requires_grad=False``) of the same name with a float32
    ``<name>_scale`` buffer beside it on its module; under ``w8a8`` a
    hooked layer (not a weight-only param) also gets an ``input_scale``
    buffer, max(stat, 1e-12) / 127. Smaller weights stay float. Returns
    ``model``."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}")
    for name, stat in stats.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        w = getattr(owner, leaf)
        if w.numel() < min_size or not w.is_floating_point():
            continue
        q, scale = quantize_array(w)
        setattr(owner, leaf, nn.Parameter(q, requires_grad=False))
        owner.register_buffer(f"{leaf}_scale", scale)
        if mode == "w8a8" and stat is not None:
            owner.register_buffer("input_scale", torch.tensor(
                max(stat, 1e-12) / 127.0, dtype=torch.float32,
                device=q.device))
    return pad_weights(model)


@torch.no_grad()
def load_quantized(model: nn.Module, state) -> nn.Module:
    """Load a state dict holding int8 weights (a quantized port model's,
    or ``core.weights.state_dict_from_jax`` of a tree the JAX package
    quantized) strictly into ``model``, a float model of the same
    architecture already in its serving dtype: each int8 weight takes its
    parameter's place (``requires_grad=False``) and each scale its buffer,
    float32, before the load. Returns ``model``."""
    for name, value in state.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        device = next(owner.parameters()).device
        if value.dtype == torch.int8:
            setattr(owner, leaf, nn.Parameter(
                torch.empty(value.shape, dtype=torch.int8, device=device),
                requires_grad=False))
        elif leaf == "input_scale" or leaf.endswith("weight_scale"):
            owner.register_buffer(leaf, torch.empty(
                value.shape, dtype=torch.float32, device=device))
    model.load_state_dict(state, strict=True)
    return pad_weights(model)


def quantize_for_serving(model: nn.Module, batches: Iterable[torch.Tensor],
                         mode: str = "w8",
                         min_size: int = DEFAULT_MIN_WEIGHT_SIZE,
                         stat: str = "amax") -> nn.Module:
    """Discover, calibrate and quantize ``model`` in place (eval mode, its
    weights already in the serving dtype). Returns ``model``."""
    return quantize_model(model, calibrate(model, batches, stat), mode=mode,
                          min_size=min_size)
