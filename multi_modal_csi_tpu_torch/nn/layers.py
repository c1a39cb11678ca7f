"""Layers with the JAX package's semantics (``nn/layers.py`` there), in
PyTorch, for serving (eval mode) and training.

Layout is channels-last, (batch, length, features) and (batch, T, H, W,
features) for video, as in the JAX package, so both packages' layers take
the same arrays. Parameter names follow the reference torch state-dict
layout.

Dtypes follow JAX's promotion step for step, because bf16 serving casts only
the weights (``core/serving.py``) and JAX then decides per operation where
values are rounded:

- a matrix product accumulates in f32 and its result takes the promoted
  type of its operands (``dense``), so an f32 activation meeting a bf16
  weight is computed in f32;
- LayerNorm and BatchNorm compute in f32 and return the promoted type of
  input and parameters;
- attention keys its serving dtype on the parameter dtype, since
  activations may arrive in f32 in bf16 serving;
- an f32 convolution (``Conv1d``, ``Conv2d``, ``Conv3d``) and the f32
  ``LSTM`` run in full f32 on the card: cuDNN's TF32 flag is off around
  each call (``core/device.py::cudnn_f32``), whatever the caller left it
  at.

Training: BatchNorm uses batch statistics and updates its running ones as
torch does; dropout draws its masks from the generator that
``dropout_generator`` installs for the step (the global one outside it).
Inside a data-parallel step (``parallel/collectives.py::axis_scope`` with a
"data" axis) both are the global batch's: BatchNorm averages its
statistics over the axis's ranks, and every mask is drawn at the global
batch's shape, then cut to this rank's rows, so N ranks compute what one
rank computes on the whole batch.

int8 serving (``core/quantize.py``): an int8 weight is the signal, as in
JAX. ``Linear``, ``Conv1d``, ``Conv2d`` and a hooked ``Conv3d``
(``hooked=True``: ResNet3D's and S3D's convs, JAX's ``Conv3D`` wrapper)
with an int8 weight run the quantized product (w8, or w8a8 when an
``input_scale`` buffer is present) and otherwise record their input under
calibration; ``MultiheadAttention``'s packed projections are weight-only.
An unhooked ``Conv3d`` (MViT's and Swin's, raw ``nn.Conv`` in JAX) and
``LSTM`` never announce themselves, as in JAX.

``LSTM`` follows JAX's mixed precision (``nn/layers.py:538-562`` there):
the gates in f32 whatever the operands, the cell state in f32 across
steps, only h cast to the activation dtype. In f32 that is
``torch.lstm``'s own function (cuDNN on the card); any other dtype runs
the steps in ``lstm_steps``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..core.device import cudnn_f32
from ..core.quantize import (conv_forward, conv_nd_forward, dense_forward,
                             mark_weight_only, record_input)
from ..kernels.flash_attention import (backward_fits, flash_attention,
                                       flash_attention_trainable,
                                       forward_fits)
from ..parallel.collectives import (axis_present, axis_size,
                                    copy_to_region, gather_features,
                                    global_rows, local_rows, local_slice,
                                    pmean, reduce_from_region)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from .init import torch_bias_, torch_linear_weight_, xavier_uniform_


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], out_dtype: torch.dtype
          ) -> torch.Tensor:
    """x @ weight.T + bias with f32 accumulation, returned in out_dtype.

    When x, weight and the output are all bf16 this is one bf16 product
    (f32 accumulation, one rounding). Otherwise the operands are promoted to
    f32, as JAX promotes a mixed f32 x bf16 product.
    """
    if x.dtype == weight.dtype == out_dtype and (
            bias is None or bias.dtype == out_dtype):
        return F.linear(x, weight, bias)
    y = F.linear(x.float(), weight.float(),
                 None if bias is None else bias.float())
    return y.to(out_dtype)


def local_tensor(p: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a tensor-parallel parameter (a DTensor that
    ``parallel/partition.py::shard_params`` placed on the "model" axis),
    else ``p``. A shard runs only inside ``axis_scope`` of a mesh whose
    "model" axis has as many ranks as the parameter has shards (else
    RuntimeError: unbound, the sums over the axis would be skipped)."""
    if not isinstance(p, DTensor):
        return p
    local = p.to_local()
    shards = p.numel() // max(local.numel(), 1)
    if axis_size(MODEL_AXIS) != shards:
        raise RuntimeError(
            f"a tensor-parallel parameter of {shards} shards runs inside "
            f"axis_scope of the mesh it was placed on (the model axis has "
            f"{axis_size(MODEL_AXIS)} ranks here)")
    return local


def call_shared(module: nn.Module, *args):
    """``module(*args)`` with each of its parameters routed through
    ``copy_to_region``: a parameter replicated over the model axis but
    used inside a sharded region (a table or a pooling conv shared by
    every head), whose gradient on each rank is its shard's part, so the
    sum over the axis makes it whole and equal on every rank."""
    from torch.func import functional_call
    params = {name: copy_to_region(p, MODEL_AXIS)
              for name, p in module.named_parameters()}
    return functional_call(module, params, args)


def row_parallel(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor], out_dtype: torch.dtype
                 ) -> torch.Tensor:
    """A row-parallel product: this rank's columns of ``weight`` times its
    part of x, summed over the model axis, then the bias, added once."""
    y = reduce_from_region(dense(x, local_tensor(weight), None, out_dtype),
                           MODEL_AXIS)
    return y if bias is None else (y + bias).to(out_dtype)


class Linear(nn.Module):
    """torch.nn.Linear's parameters, xavier-uniform or torch-default weight,
    torch-default bias; the output keeps the input's dtype. With an int8
    weight (``core/quantize.py``) the product is the quantized one, in f32,
    plus the bias, cast to the input's dtype.

    Under the tensor-parallel rules (``parallel/partition.py``)
    ``parallel`` is "column" (the weight's rows and the bias sharded: the
    input enters the region through ``copy_to_region``, the output is
    this rank's features) or "row" (the weight's columns sharded: the
    input is this rank's features, the output the sum over the axis plus
    the whole bias)."""

    parallel: Optional[str] = None

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, xavier: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        (xavier_uniform_ if xavier else torch_linear_weight_)(
            self.weight, generator)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_features))
            torch_bias_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == torch.int8:
            return dense_forward(x, self.weight, self.weight_scale,
                                 getattr(self, "input_scale", None),
                                 self.bias, x.dtype,
                                 getattr(self, "weight_padded", None))
        record_input(self, x)
        if self.parallel == "column":
            return dense(copy_to_region(x, MODEL_AXIS),
                         local_tensor(self.weight), local_tensor(self.bias),
                         x.dtype)
        if self.parallel == "row":
            return row_parallel(x, self.weight, self.bias, x.dtype)
        return dense(x, self.weight, self.bias, x.dtype)


def _same_pads(length: int, kernel: int, stride: int,
               dilation: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: output ceil(L / stride), the odd pad at the
    end (kernel 2 pads (0, 1))."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - length, 0)
    return total // 2, total - total // 2


class Conv1d(nn.Module):
    """1-D convolution on (B, L, C) with torch Conv1d's parameters.

    ``padding`` is an int (both sides), "SAME" or "VALID". Input, weight
    and bias are promoted to one dtype, in which the convolution runs. With
    an int8 weight (``core/quantize.py``) the convolution is the quantized
    product over the padded input's columns, in f32, plus the bias, cast to
    the input's dtype.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, stride: int = 1, padding: Union[int, str] = "VALID",
                 dilation: int = 1, groups: int = 1, bias: bool = True,
                 xavier: bool = True, generator: torch.Generator):
        super().__init__()
        if isinstance(padding, str) and padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be an int, SAME or VALID, got "
                             f"{padding!r}")
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size))
        (xavier_uniform_ if xavier else torch_linear_weight_)(
            self.weight, generator)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
            torch_bias_(self.bias, in_channels // groups * kernel_size,
                        generator)

    def pads(self, length: int) -> Tuple[int, int]:
        if self.padding == "VALID":
            return 0, 0
        if self.padding == "SAME":
            return _same_pads(length, self.weight.shape[-1], self.stride,
                              self.dilation)
        return self.padding, self.padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == torch.int8:
            return conv_forward(x, self.weight, self.weight_scale,
                                getattr(self, "input_scale", None),
                                pads=self.pads(x.shape[1]),
                                stride=self.stride, dilation=self.dilation,
                                groups=self.groups, bias=self.bias,
                                out_dtype=x.dtype,
                                padded=getattr(self, "weight_padded", None))
        record_input(self, x)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        if self.bias is not None:
            dtype = torch.promote_types(dtype, self.bias.dtype)
        xt = F.pad(x.transpose(1, 2).to(dtype), self.pads(x.shape[1]))
        with cudnn_f32():
            y = F.conv1d(xt, self.weight.to(dtype),
                         None if self.bias is None else self.bias.to(dtype),
                         stride=self.stride, dilation=self.dilation,
                         groups=self.groups)
        return y.transpose(1, 2)


Pair = Tuple[int, int]


class Conv2d(nn.Module):
    """2-D convolution on channels-last (B, H, W, C), VALID, with torch
    Conv2d's parameters (weight (out, in, kh, kw), bias), xavier-uniform
    weight and torch-default bias.

    Input, weight and bias are promoted to one dtype, in which the
    convolution runs (as flax promotes); ``F.conv2d`` takes the input as
    a channels-last view, so the module keeps (B, H, W, C) at its edges and
    BatchNorm normalises the trailing axis. A hooked Conv2d (the default,
    JAX's ``Conv2d`` through ``_ConvCore``) records its input under
    calibration, and with an int8 weight (``core/quantize.py``) the
    convolution is the quantized one of a 3-D window of one frame
    (``conv_nd_forward``: the implicit conv from 16 channels, else the
    product over the input's 2-D columns), in f32, plus the bias, cast to
    the input's dtype. ``hooked=False`` never announces (CNN-2D's stage 0,
    whose JAX parameters are raw).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: Pair,
                 *, stride: Pair = (1, 1), hooked: bool = True,
                 generator: torch.Generator):
        super().__init__()
        self.stride, self.hooked = stride, hooked
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel))
        xavier_uniform_(self.weight, generator)
        self.bias = nn.Parameter(torch.empty(out_channels))
        torch_bias_(self.bias, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == torch.int8:
            return conv_nd_forward(
                x[:, None], self.weight[:, :, None], self.weight_scale,
                getattr(self, "input_scale", None),
                stride=(1, *self.stride), padding=(0, 0, 0), bias=self.bias,
                out_dtype=x.dtype,
                padded=getattr(self, "weight_padded", None),
                taps=getattr(self, "weight_taps", None))[:, 0]
        if self.hooked:
            record_input(self, x)
        dtype = torch.promote_types(
            torch.promote_types(x.dtype, self.weight.dtype), self.bias.dtype)
        with cudnn_f32():
            y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2),
                         self.weight.to(dtype), self.bias.to(dtype),
                         stride=self.stride)
        return y.permute(0, 2, 3, 1)


Triple = Tuple[int, int, int]


class Conv3d(nn.Module):
    """3-D convolution on channels-last (B, T, H, W, C) with torch Conv3d's
    parameters (weight (out, in/groups, kt, kh, kw), bias) and explicit
    symmetric padding per axis, as the JAX package pads its video convs.

    Input, weight and bias are promoted to one dtype, in which the
    convolution runs (as flax promotes). The input is handed to
    ``F.conv3d`` as a contiguous channels-first copy: given the
    channels-last view instead, cuDNN runs a depthwise conv (MViT's
    pooling) as one kernel per group, many times slower on the card than
    PyTorch's own depthwise kernel, which takes the contiguous layout.

    ``hooked=True`` (ResNet3D's and S3D's convs, which JAX runs through its
    int8-hookable ``Conv3D`` wrapper) records the input under calibration,
    and with an int8 weight (``core/quantize.py``) the convolution is the
    quantized one (``conv_nd_forward``: the implicit conv from 16
    channels, else the product over the input's 3-D columns), in f32, plus
    the bias, cast to the input's dtype. Only ungrouped convs are hooked.
    ``weight_init`` draws the weight (PyTorch's default unless given).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel: Triple,
                 *, stride: Triple = (1, 1, 1), padding: Triple = (0, 0, 0),
                 groups: int = 1, bias: bool = True, hooked: bool = False,
                 weight_init=torch_linear_weight_,
                 generator: torch.Generator):
        super().__init__()
        if hooked and groups != 1:
            raise ValueError("a hooked Conv3d is ungrouped")
        self.stride, self.padding, self.groups = stride, padding, groups
        self.hooked = hooked
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *kernel))
        weight_init(self.weight, generator)
        self.bias = None
        if bias:
            self.bias = nn.Parameter(torch.empty(out_channels))
            torch_bias_(self.bias, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.hooked:
            if self.weight.dtype == torch.int8:
                return conv_nd_forward(
                    x, self.weight, self.weight_scale,
                    getattr(self, "input_scale", None), stride=self.stride,
                    padding=self.padding, bias=self.bias, out_dtype=x.dtype,
                    padded=getattr(self, "weight_padded", None),
                    taps=getattr(self, "weight_taps", None))
            record_input(self, x)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        if self.bias is not None:
            dtype = torch.promote_types(dtype, self.bias.dtype)
        with cudnn_f32():
            y = F.conv3d(x.to(dtype).permute(0, 4, 1, 2, 3).contiguous(),
                         self.weight.to(dtype),
                         None if self.bias is None else self.bias.to(dtype),
                         stride=self.stride, padding=self.padding,
                         groups=self.groups)
        return y.permute(0, 2, 3, 4, 1)


def max_pool3d(x: torch.Tensor, kernel: Triple, stride: Triple,
               padding: Triple) -> torch.Tensor:
    """Max pooling on channels-last (B, T, H, W, C). The padding never wins
    (torch pads with -inf, as flax's ``max_pool`` does)."""
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel, stride,
                        padding).permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, kernel: Triple) -> torch.Tensor:
    """Average pooling on channels-last (B, T, H, W, C): stride 1, VALID
    (flax's ``avg_pool`` with ``padding="VALID"``), summed in f32 (the CPU
    has no bf16 kernel) and returned in x's dtype."""
    y = F.avg_pool3d(x.float().permute(0, 4, 1, 2, 3), kernel, stride=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


class GELU(nn.Module):
    """flax's ``nn.gelu``, whose default is the tanh approximation (not the
    exact erf GELU of torch's default and torchvision's MViT)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh")


class BatchNorm(nn.Module):
    """BatchNorm over the trailing feature axis of (B, ..., C), with torch
    BatchNorm's parameter and buffer names; eps 1e-5 and momentum 0.1 (the
    torch convention: new = (1 - m) old + m batch) unless given (S3D's:
    flax momentum 0.999, so m = 1 - 0.999, and eps 1e-3).

    Eval mode normalises with the running statistics. Training mode is the
    JAX package's torch-exact core (``_TorchBNCore``): batch mean and
    E[x^2] - E[x]^2 in f32 over every axis but the last, normalisation with
    that biased variance, and running statistics updated with the
    momentum, the variance unbiased (x n / (n - 1)). Inside a
    data-parallel step the mean and E[x^2] are averaged over the "data"
    ranks (with autograd) and n is the global count, as
    ``SyncBatchNorm`` does. The output takes the promoted dtype of input
    and parameters in both modes.
    """

    def __init__(self, features: int, *, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            n = math.prod(x.shape[a] for a in axes)
            mean = xf.mean(dim=axes)
            square = (xf * xf).mean(dim=axes)
            if axis_present(DATA_AXIS):
                # the global batch's: every rank holds as many rows
                mean, square = pmean(torch.stack([mean, square]))
                n *= axis_size(DATA_AXIS)
            var = square - mean * mean
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


_GENERATOR: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]
                      ) -> Iterator[None]:
    """Draw every dropout mask inside the block from ``generator`` (on the
    activations' device)."""
    global _GENERATOR
    previous, _GENERATOR = _GENERATOR, generator
    try:
        yield
    finally:
        _GENERATOR = previous


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None,
            model_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout as flax's: keep each element with probability
    1 - p and divide the kept ones by 1 - p in x's dtype. ``F.dropout``
    takes no generator, hence this. The batch is dimension 0; inside a
    data-parallel step the mask is this rank's rows of the global
    batch's. ``model_dim`` is the dimension of x sharded over the model
    axis (a column-parallel activation's features, or the heads): the
    mask is drawn at the unsharded shape and cut there too, so a step
    under the rules draws what one process draws."""
    if p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    shape = list(global_rows(x.shape))
    if model_dim is not None:
        shape[model_dim] *= axis_size(MODEL_AXIS)
    mask = local_rows(torch.rand(shape, generator=generator,
                                 device=x.device))
    if model_dim is not None:
        mask = local_slice(mask, model_dim, MODEL_AXIS)
    mask = mask < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class Dropout(nn.Module):
    """``dropout`` in training mode, with the generator that
    ``dropout_generator`` installed; the identity in eval mode.
    ``model_dim`` is set by the tensor-parallel rules on a dropout between
    a column- and a row-parallel Linear (its input's features are
    sharded)."""

    model_dim: Optional[int] = None

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.p, _GENERATOR, self.model_dim)


class DropPath(nn.Module):
    """Stochastic depth as the JAX package's MViT ``DropPath``: in training
    each sample is kept with probability 1 - rate and the kept ones are
    divided by 1 - rate, the mask drawn from the generator that
    ``dropout_generator`` installed; the identity in eval mode."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = global_rows((x.shape[0],) + (1,) * (x.dim() - 1))
        mask = local_rows(torch.rand(shape, generator=_GENERATOR,
                                     device=x.device)) < keep
        return x * mask.to(x.dtype) / keep


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis, computed in f32. eps is 1e-6, the
    JAX package's (and the reference's), not torch's 1e-5."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def avg_pool1d(x: torch.Tensor, kernel: int,
               stride: Optional[int] = None) -> torch.Tensor:
    """torch AvgPool1d on (B, L, C): VALID, floor length."""
    return F.avg_pool1d(x.transpose(1, 2), kernel, stride or kernel
                        ).transpose(1, 2)


def adaptive_avg_pool1d(x: torch.Tensor, output_size: int) -> torch.Tensor:
    """torch AdaptiveAvgPool1d on (B, L, C): bin i is the mean over steps
    [floor(i L / out), ceil((i + 1) L / out)), so bins overlap when out
    does not divide L (3000 to 270). The JAX package takes segment means
    with the same bounds."""
    return F.adaptive_avg_pool1d(x.transpose(1, 2), output_size
                                 ).transpose(1, 2)


def max_pool1d(x: torch.Tensor, kernel: int,
               stride: Optional[int] = None) -> torch.Tensor:
    """torch MaxPool1d on (B, L, C): VALID, floor length."""
    return F.max_pool1d(x.transpose(1, 2), kernel, stride or kernel
                        ).transpose(1, 2)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """torch's default negative slope, 0.01."""
    return F.leaky_relu(x, 0.01)


def lstm_steps(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
               b_ih: torch.Tensor, b_hh: torch.Tensor) -> torch.Tensor:
    """One LSTM direction over batch-first x (B, L, F) as the JAX
    package's scan computes it, for any dtype: the input product of every
    step at once and each step's hidden product in f32 (bf16 operands
    widened, so the products are exact and the sums f32), the gates
    (x W_ih^T + h W_hh^T) + b_ih + b_hh in f32, gate order i, f, g, o, the
    cell state c in f32 across steps, h cast to x's dtype each step.
    Returns (B, L, H) in x's dtype."""
    b, length, _ = x.shape
    hidden = w_hh.shape[1]
    xw = dense(x, w_ih, None, torch.float32)
    w_hh_t = w_hh.float().t()
    b_ih, b_hh = b_ih.float(), b_hh.float()
    h = x.new_zeros((b, hidden))
    c = torch.zeros((b, hidden), dtype=torch.float32, device=x.device)
    out = []
    for t in range(length):
        gates = xw[:, t] + h.float() @ w_hh_t + b_ih + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(x.dtype)
        out.append(h)
    return torch.stack(out, dim=1)


class LSTM(nn.Module):
    """torch.nn.LSTM's function and parameter names for one batch-first
    layer, optionally bidirectional: ``weight_ih_l0`` (4H, F),
    ``weight_hh_l0`` (4H, H), ``bias_ih_l0``, ``bias_hh_l0`` (both kept),
    and the same with ``_reverse``; every one uniform(+-1/sqrt(H)). (B, L,
    F) in, (B, L, H) or (B, L, 2H) out, the backward direction run on the
    reversed sequence and its outputs reversed back, as in JAX.

    Precision is JAX's: f32 input and weights take ``torch.lstm`` (cuDNN
    on the card, PyTorch's own kernels on the CPU), which computes that
    function in f32; any other dtype takes ``lstm_steps``, because
    ``torch.lstm`` in bf16 keeps c in bf16 and rounds the gates, and over
    300 steps bf16 serving would drift from JAX.
    """

    def __init__(self, in_features: int, hidden: int, *,
                 bidirectional: bool = False, generator: torch.Generator):
        super().__init__()
        self.hidden, self.bidirectional = hidden, bidirectional
        bound = 1.0 / math.sqrt(hidden)
        for suffix in self._suffixes():
            for name, shape in (("weight_ih", (4 * hidden, in_features)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)),
                                ("bias_hh", (4 * hidden,))):
                p = nn.Parameter(torch.empty(shape))
                with torch.no_grad():
                    p.uniform_(-bound, bound, generator=generator)
                self.register_parameter(f"{name}_{suffix}", p)

    def _suffixes(self) -> Tuple[str, ...]:
        return ("l0", "l0_reverse") if self.bidirectional else ("l0",)

    def _params(self, suffix: str):
        return [getattr(self, f"{name}_{suffix}") for name in
                ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [p for s in self._suffixes() for p in self._params(s)]
        if x.dtype == torch.float32 and all(
                p.dtype == torch.float32 for p in params):
            zeros = x.new_zeros((len(self._suffixes()), x.shape[0],
                                 self.hidden))
            with cudnn_f32():
                return torch.lstm(x, (zeros, zeros), params, True, 1, 0.0,
                                  self.training, self.bidirectional,
                                  True)[0]
        out = lstm_steps(x, *self._params("l0"))
        if not self.bidirectional:
            return out
        back = lstm_steps(x.flip(1), *self._params("l0_reverse")).flip(1)
        return torch.cat([out, back], dim=-1)


KV = Tuple[torch.Tensor, torch.Tensor]


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (batch-first, one embed
    dim): packed ``in_proj_weight``/``in_proj_bias`` with xavier weight and
    zero bias, ``out_proj`` with torch-default weight and zero bias.

    ``output_scale`` is the reference's temperature: it divides the
    attention OUTPUT, not the logits. ``dropout`` is the attention-weight
    dropout of training. ``kv``/``return_kv`` let a weight-shared decoder
    project a fixed memory's K/V once and reuse it.

    With at least 64 query and 64 key tokens, attention runs in the fused
    kernels (``kernels/flash_attention.py``), as in the JAX package
    (``nn/layers.py:433-437`` there): in eval mode K1 in the serving
    dtype, when its kernel takes the head dim (``forward_fits``: D <= 128;
    any Nk in either dtype, as JAX's gate); in training, when ``dropout``
    is 0 and K2's operands fit too (``backward_fits``),
    ``flash_attention_trainable`` (K1 forward, K2 backward). The gate looks
    at shapes and dtypes, never at the device: on CPU tensors the kernels'
    plain versions run. Other shapes take the eager branch, which in bf16
    rounds logits and weights to bf16 as the JAX package does (whose K2
    takes XLA's backward where a row does not fit).

    Under the tensor-parallel rules (``parallel/partition.py``;
    ``model_shards`` is the model axis's size) this rank holds the rows
    of q, k and v of its heads and the matching columns of ``out_proj``:
    the inputs enter through ``copy_to_region``, the attention core (K1/K2
    through the same gate, or the eager branch with its dropout drawn at
    all the heads and cut to this rank's) runs on this rank's heads, and
    ``out_proj``'s product is summed over the axis before its bias is
    added once. Where the axis does not divide the heads, q, k and v are
    gathered over the axis and the core runs whole on every rank, then
    ``out_proj`` takes this rank's columns of its output. The ``kv`` of
    the weight-shared decoder holds what the core takes.

    int8 serving: ``in_proj_weight`` and ``out_proj.weight`` are
    weight-only quantizable (never an ``input_scale``; ``out_proj`` never
    records an input). With int8 weights each projection is the bf16 x
    bf16 -> f32 product times the per-row scale plus the bias, and the
    serving dtype is the bias's, as in JAX (``nn/layers.py:377-396``,
    ``:441-445``).
    """

    TENSOR_PARALLEL_PAIRS = (("in_proj_weight", "out_proj.weight"),)
    model_shards: Optional[int] = None

    def __init__(self, embed_dim: int, num_heads: int, *,
                 dropout: float = 0.0, output_scale: float = 1.0,
                 generator: torch.Generator):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.output_scale = dropout, output_scale
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        xavier_uniform_(self.in_proj_weight, generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, xavier=False,
                               generator=generator)
        with torch.no_grad():
            self.out_proj.bias.zero_()

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, kv: Optional[KV] = None,
                return_kv: bool = False
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, KV]]:
        e, h = self.embed_dim, self.num_heads
        d = e // h
        w, b = self.in_proj_weight, self.in_proj_bias
        quantized = w.dtype == torch.int8
        if not quantized:
            mark_weight_only(self, "in_proj_weight", "out_proj.weight")
        sharded = self.model_shards is not None
        if sharded:
            w, b = local_tensor(w), local_tensor(b)
            query, key, value = (copy_to_region(t, MODEL_AXIS)
                                 for t in (query, key, value))
        el = w.shape[0] // 3           # this rank's rows of each of q, k, v
        whole = h % (e // el) != 0     # heads the model axis cuts
        hl = h if whole else h * el // e
        # the serving dtype is the parameters' dtype (the bias's under int8
        # weights)
        act = (torch.bfloat16 if (b if quantized else w).dtype
               == torch.bfloat16 else torch.float32)
        nq, nk = query.shape[1], (key if kv is None else kv[0]).shape[1]
        shapes_ok = nq >= 64 and nk >= 64 and forward_fits(nk, d, act)
        if self.training:
            fused = flash_attention_trainable if (
                shapes_ok and self.dropout == 0.0
                and backward_fits(nq, nk, d, act)) else None
        else:
            fused = flash_attention if shapes_ok else None
        # the fused branch projects straight into the serving dtype; the
        # eager branch keeps q, k, v in f32
        proj_dtype = act if fused is not None else torch.float32

        def project(x, part):
            lo, hi = part * el, (part + 1) * el
            if quantized:
                padded = getattr(self, "in_proj_weight_padded", None)
                return dense_forward(
                    x, w[lo:hi], self.in_proj_weight_scale[lo:hi], None,
                    b[lo:hi], proj_dtype,
                    None if padded is None else padded[lo:hi])
            return dense(x, w[lo:hi], b[lo:hi], proj_dtype)

        def split(t):
            if whole:
                t = gather_features(t, MODEL_AXIS)
            return t.reshape(*t.shape[:-1], hl, d)

        q = split(project(query, 0))
        if kv is None:
            kv = (split(project(key, 1)), split(project(value, 2)))
        k, v = kv
        if fused is not None:
            ctx = fused(q, k.to(act).contiguous(), v.to(act).contiguous())
        else:
            p = self.dropout if self.training else 0.0
            ctx = _eager_attention(q, k, v, act, p,
                                   1 if sharded and not whole else None)
        ctx = ctx.reshape(*query.shape[:-1], hl * d)
        if whole and sharded:
            ctx = local_slice(ctx, -1, MODEL_AXIS)

        wo, bo = self.out_proj.weight, self.out_proj.bias
        scaled = self.output_scale != 1.0
        out_dtype = torch.float32 if scaled else query.dtype
        if wo.dtype == torch.int8:
            out = dense_forward(ctx, wo, self.out_proj.weight_scale, None, bo,
                                out_dtype,
                                getattr(self.out_proj, "weight_padded", None))
        elif sharded:
            out = row_parallel(ctx, wo, bo, out_dtype)
        else:
            out = dense(ctx, wo, bo, out_dtype)
        if scaled:
            out = out * (1.0 / self.output_scale)
        out = out.to(query.dtype)
        return (out, kv) if return_kv else out


def _eager_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     act: torch.dtype, p: float = 0.0,
                     model_dim: Optional[int] = None) -> torch.Tensor:
    """The gate's other branch, for short sequences (DETR's 10 memory
    tokens and 5 queries). f32 q, k, v; in bf16 the (B, H, Nq, Nk) logits,
    exp and weights are rounded to bf16, the row sum accumulates in f32,
    and P.V runs in f32. ``p`` is the training dropout on the weights
    (``model_dim`` 1 where the heads are this rank's of the model axis);
    the row max takes no gradient, as in JAX."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).to(act)
    logits = logits / math.sqrt(d)
    unnorm = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    weights = unnorm / unnorm.sum(dim=-1, keepdim=True,
                                  dtype=torch.float32).to(act)
    if p > 0.0:
        weights = dropout(weights, p, _GENERATOR, model_dim)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float())
