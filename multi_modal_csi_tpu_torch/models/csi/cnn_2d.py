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

int8 serving raises NotImplementedError: JAX quantizes stages 1 and 2
(its stage 0's raw parameters never announce), whose 2-D columns the
prologue does not write yet (ROADMAP item 12). The serving fold of norm_0
into stage 0 (``fold_input_norm``) comes with the export CLI (item 13b).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import BatchNorm, Conv2d, Dropout, Linear, leaky_relu

STAGES = ((32, 27, 7), (64, 15, 3), (128, 7, 1))      # features, k, stride


class CNN2D(nn.Module):
    """(B, length, channels) windows, or (B, T, F, 1), to (B,
    out_features)."""

    def __init__(self, out_features: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        widths = (1,) + tuple(f for f, _, _ in STAGES)
        for i, (feat, k, s) in enumerate(STAGES):
            setattr(self, f"layer_norm_{i}", BatchNorm(widths[i]))
            setattr(self, f"layer_cnn_2d_{i}",
                    Conv2d(widths[i], feat, (k, k), stride=(s, s),
                           generator=g))
        self.layer_norm_3 = BatchNorm(widths[-1])
        self.dropout = Dropout(0.2)
        self.layer_linear = Linear(widths[-1], out_features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        for i in range(len(STAGES)):
            x = getattr(self, f"layer_norm_{i}")(x)
            x = leaky_relu(getattr(self, f"layer_cnn_2d_{i}")(x))
            x = self.dropout(x)
        x = self.layer_norm_3(x)
        return self.layer_linear(x.mean(dim=(1, 2)))
