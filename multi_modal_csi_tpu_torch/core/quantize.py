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
``input_scale`` buffer beside it selects w8a8. Both products run in
``kernels/int8_matmul.py`` (the hand-written kernel on the card).

Which layers are quantized is decided by discovery, as in JAX: ``Linear``
and ``Conv1d`` (``nn/layers.py``) record their input's max-abs (or its
99.9th percentile) while a calibration is recording, and
``MultiheadAttention`` announces its packed ``in_proj_weight`` and
``out_proj.weight`` as weight-only (cross-attention feeds two inputs, so
no per-tensor activation scale applies; ``out_proj`` never records an
input). ``Conv3d`` never announces itself, as JAX's MViT convs are raw
``nn.Conv``: a layer that never announced can never be turned int8.

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
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch
from torch import nn

from ..kernels.int8_matmul import bf16_matmul_f32, int8_matmul

# weights smaller than this stay float: tiny layers save nothing and lose
# the most precision (10-class heads)
DEFAULT_MIN_WEIGHT_SIZE = 16384
MODES = ("w8", "w8a8")
STATS = ("amax", "p999")

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


def quantize_activation(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """Per-tensor symmetric int8 with a fixed (calibrated) scale."""
    q = torch.round(x.float() / scale)
    return q.clamp(-127, 127).to(torch.int8)


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

def _operand(x: torch.Tensor,
             input_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """The activation as the product takes it: bf16 (w8) or int8 (w8a8)."""
    if input_scale is None:
        return x.to(torch.bfloat16)
    return quantize_activation(x, input_scale)


def _product(a: torch.Tensor, weight: torch.Tensor,
             weight_scale: torch.Tensor,
             input_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """(..., M, K) x (..., N, K)^T in f32 with the rescale, for an operand
    from ``_operand``: w8 in bf16 on the dequantised weight, w8a8 in int8
    (the two scales multiplied first, as JAX does)."""
    if input_scale is None:
        y = bf16_matmul_f32(a, weight.to(torch.bfloat16))
        return y * weight_scale
    y = int8_matmul(a, weight)
    return y.float() * (weight_scale * input_scale)


def dense_forward(x: torch.Tensor, weight: torch.Tensor,
                  weight_scale: torch.Tensor,
                  input_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ dequant(weight)^T in float32 for an int8 (out, in) weight."""
    a = _operand(x.reshape(-1, x.shape[-1]), input_scale)
    y = _product(a, weight, weight_scale, input_scale)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def conv_forward(x: torch.Tensor, weight: torch.Tensor,
                 weight_scale: torch.Tensor,
                 input_scale: Optional[torch.Tensor], *,
                 pads: Tuple[int, int], stride: int, dilation: int,
                 groups: int) -> torch.Tensor:
    """A 1-D convolution of channels-last x (B, L, C) with an int8 weight
    (N, C/groups, k), as float32 (B, L_out, N): the padded input (int8 for
    w8a8, bf16 for w8) unfolded into (B L_out, C k) columns in the weight's
    (channel, tap) order, one product per group, the groups as the
    product's batch dimension."""
    n, cg, k = weight.shape
    x = _operand(x, input_scale)
    span = (k - 1) * dilation + 1
    cols = torch.nn.functional.pad(x, (0, 0, *pads)).unfold(1, span, stride)
    cols = cols[..., ::dilation]                       # (B, L_out, C, k)
    b, lout = cols.shape[:2]
    a = cols.reshape(b * lout, groups, cg * k)
    w = weight.reshape(groups, n // groups, cg * k)
    if groups == 1:
        y = _product(a[:, 0], w[0], weight_scale, input_scale)
    else:
        y = _product(a.transpose(0, 1), w, weight_scale.reshape(
            groups, 1, n // groups), input_scale).transpose(0, 1)
    return y.reshape(b, lout, n)


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
    return model


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
    return model


def quantize_for_serving(model: nn.Module, batches: Iterable[torch.Tensor],
                         mode: str = "w8",
                         min_size: int = DEFAULT_MIN_WEIGHT_SIZE,
                         stat: str = "amax") -> nn.Module:
    """Discover, calibrate and quantize ``model`` in place (eval mode, its
    weights already in the serving dtype). Returns ``model``."""
    return quantize_model(model, calibrate(model, batches, stat), mode=mode,
                          min_size=min_size)
