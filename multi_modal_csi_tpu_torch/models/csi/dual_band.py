"""Dual-band CSI fusion model (counterpart of the JAX package's
``models/csi/dual_band.py``; reference ``wifi_csi/model/dual_band.py:24-57``):
one CNN-1D tower per WiFi band, each with a 512-wide output, concatenated,
fused by Linear(1024 -> 512), refined by three residual Linear(512) + ReLU
blocks and classified by a final Linear; the fusion Linears take torch's
default initialisation. The input is (B, 2, T, C): band 1 (2.4 GHz) at
``x[:, 0]`` into ``cnn_band1``, band 2 (5 GHz) at ``x[:, 1]`` into
``cnn_band2``. Parameter names are the reference's (``cnn_band{1,2}.*``,
``combine_linear``, ``linear{1,2,3}``, ``final_linear``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import Linear
from .cnn_1d import CNN1D

EMBED_DIM = 512   # each tower's output and the fused width


class DualBandCNN(nn.Module):
    """(B, 2, length, channels) paired windows to (B, out_features)."""

    def __init__(self, out_features: int, *, channels: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.cnn_band1 = CNN1D(EMBED_DIM, channels=channels, generator=g)
        self.cnn_band2 = CNN1D(EMBED_DIM, channels=channels, generator=g)
        self.combine_linear = Linear(2 * EMBED_DIM, EMBED_DIM, xavier=False,
                                     generator=g)
        for i in (1, 2, 3):
            setattr(self, f"linear{i}",
                    Linear(EMBED_DIM, EMBED_DIM, xavier=False, generator=g))
        self.final_linear = Linear(EMBED_DIM, out_features, xavier=False,
                                   generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([self.cnn_band1(x[:, 0]), self.cnn_band2(x[:, 1])],
                      dim=-1)
        h = self.combine_linear(h)
        for i in (1, 2, 3):
            h = torch.relu(getattr(self, f"linear{i}")(h) + h)
        return self.final_linear(h)
