"""CLSTM: a strided large-kernel conv front end and an LSTM (counterpart of
the JAX package's ``models/csi/clstm.py``; reference
``wifi_csi/model/cnn_lstm.py``): BatchNorm, three Conv1d stages (64 k128
s8, 128 k64 s4, 256 k32 s2) each with LeakyReLU and BatchNorm, LSTM(512),
the last step, Dropout(0.5) and a Linear head; xavier conv and Linear
weights. Parameter names follow the reference torch layout
(``layer_norm``, ``layer_cnn_1d_{i}``, ``layer_norm_{i}``, ``layer_lstm``,
``layer_linear``).

At full width the stages give 3000 -> 360 -> 75 -> 22 steps. The LSTM
keeps JAX's mixed precision (``nn/layers.py::LSTM``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import (LSTM, BatchNorm, Conv1d, Dropout, Linear,
                          leaky_relu)

STAGES = ((64, 128, 8), (128, 64, 4), (256, 32, 2))   # features, k, stride
HIDDEN = 512


class CLSTM(nn.Module):
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
            setattr(self, f"layer_norm_{i}", BatchNorm(feat))
        self.layer_lstm = LSTM(widths[-1], HIDDEN, generator=g)
        self.dropout = Dropout(0.5)
        self.layer_linear = Linear(HIDDEN, out_features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x)
        for i in range(len(STAGES)):
            x = leaky_relu(getattr(self, f"layer_cnn_1d_{i}")(x))
            x = getattr(self, f"layer_norm_{i}")(x)
        x = self.layer_lstm(x)[:, -1]
        return self.layer_linear(self.dropout(x))
