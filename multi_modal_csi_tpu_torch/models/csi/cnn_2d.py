"""CNN-2D: the CSI window as a one-channel (time x feature) image
(counterpart of the JAX package's ``models/csi/cnn_2d.py``; reference
``wifi_csi/model/cnn_2d.py``): per stage BatchNorm, Conv2d (32 k27 s7, 64
k15 s3, 128 k7 s1), LeakyReLU and Dropout(0.2); then a BatchNorm, the mean
over (time, feature) and a Linear head; xavier weights. Parameter names
follow the reference torch layout (``layer_norm_{i}``,
``layer_cnn_2d_{i}``, ``layer_linear``).

Channels-last (B, T, F, C), as JAX's NHWC, so each BatchNorm normalises
the trailing axis. Stage 0 is a plain Conv2d: JAX's ``_Stage0Conv``
(space-to-depth into 49 channels) is a TPU layout rewrite of the same
convolution, equal up to f32 summation order. At full width the stages
give (3000, 270) -> (425, 35) -> (137, 7) -> (131, 1).

int8 serving quantizes stages 1 and 2, as JAX does (its stage 0's raw
parameters never announce, so the port's stage 0 is an unhooked Conv2d);
their products run over the 2-D columns of the 3-D prologue.

Serving (JAX's ``models/csi/cnn_2d.py:112``): ``fold_input_norm=True``
builds the model without norm_0, for a state dict that ``fold_input_norm``
has folded that scalar affine into stage 0's conv (exact: VALID padding,
so the constant meets every tap; the export CLI folds by default).
Training keeps the live BatchNorm.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ...nn.layers import BatchNorm, Conv2d, Dropout, Linear, leaky_relu
from .mlp import StateDict, bn_affine

STAGES = ((32, 27, 7), (64, 15, 3), (128, 7, 1))      # features, k, stride


class CNN2D(nn.Module):
    """(B, length, channels) windows, or (B, T, F, 1), to (B,
    out_features)."""

    def __init__(self, out_features: int, *, fold_input_norm: bool = False,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        widths = (1,) + tuple(f for f, _, _ in STAGES)
        for i, (feat, k, s) in enumerate(STAGES):
            if i or not fold_input_norm:
                setattr(self, f"layer_norm_{i}", BatchNorm(widths[i]))
            setattr(self, f"layer_cnn_2d_{i}",
                    Conv2d(widths[i], feat, (k, k), stride=(s, s),
                           hooked=i > 0, generator=g))
        self.layer_norm_3 = BatchNorm(widths[-1])
        self.dropout = Dropout(0.2)
        self.layer_linear = Linear(widths[-1], out_features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        for i in range(len(STAGES)):
            norm = getattr(self, f"layer_norm_{i}", None)
            if norm is not None:
                x = norm(x)
            x = leaky_relu(getattr(self, f"layer_cnn_2d_{i}")(x))
            x = self.dropout(x)
        x = self.layer_norm_3(x)
        return self.layer_linear(x.mean(dim=(1, 2)))


def fold_input_norm(state: Mapping[str, torch.Tensor]) -> StateDict:
    """Fold CNN-2D's eval-mode norm_0 (a scalar affine x a + c: one input
    channel) into stage 0's conv, as JAX's ``fold_input_norm`` does (in
    float64, then float32): weight a, bias + c times the sum of each
    filter's taps. Returns the state dict of a
    ``CNN2D(fold_input_norm=True)``: no ``layer_norm_0.*``."""
    a, c = bn_affine(state, "layer_norm_0")
    sd = {k: v for k, v in state.items()
          if not k.startswith("layer_norm_0.")}
    k0 = state["layer_cnn_2d_0.weight"].double()      # (32, 1, 27, 27)
    sd["layer_cnn_2d_0.weight"] = (k0 * a).float()
    sd["layer_cnn_2d_0.bias"] = (state["layer_cnn_2d_0.bias"].double()
                                 + c * k0.sum(dim=(1, 2, 3))).float()
    return sd
