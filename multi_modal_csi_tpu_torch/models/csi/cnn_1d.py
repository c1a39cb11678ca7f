"""CNN-1D over CSI windows (counterpart of the JAX package's
``models/csi/cnn_1d.py``; reference ``wifi_csi/model/cnn_1d.py``):
BatchNorm over the channels, three strided Conv1d stages (128 k29 s13, 256
k15 s7, 512 k3 s1) each with ReLU and Dropout(0.2), the mean over time,
Dropout(0.2) and a Linear head; xavier-uniform weights. Channels-last, as
in JAX: the convs run on (B, T, C). Parameter names follow the reference
torch layout (``layer_norm``, ``layer_cnn_1d_{i}``, ``layer_linear``).

At full width the stages give 3000 -> 229 -> 31 -> 29 steps. Under int8
serving (w8a8 on request; no default) the three convs and the head take
the prologue and P1's s8 product.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import BatchNorm, Conv1d, Dropout, Linear

STAGES = ((128, 29, 13), (256, 15, 7), (512, 3, 1))   # features, k, stride


class CNN1D(nn.Module):
    """(B, length, channels) windows to (B, out_features)."""

    def __init__(self, out_features: int, *, channels: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.layer_norm = BatchNorm(channels)
        widths = (channels,) + tuple(f for f, _, _ in STAGES)
        for i, (feat, k, s) in enumerate(STAGES):
            setattr(self, f"layer_cnn_1d_{i}",
                    Conv1d(widths[i], feat, k, stride=s, generator=g))
        self.dropout = Dropout(0.2)
        self.layer_linear = Linear(widths[-1], out_features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x)
        for i in range(len(STAGES)):
            conv = getattr(self, f"layer_cnn_1d_{i}")
            x = self.dropout(torch.relu(conv(x)))
        x = self.dropout(x.mean(dim=1))
        return self.layer_linear(x)
