"""LSTM over time-pooled CSI windows (counterpart of the JAX package's
``models/csi/lstm.py``; reference ``wifi_csi/model/lstm.py``): BatchNorm
over the channels, an average pool of 10 over time (3000 -> 300 steps),
LSTM(hidden 512), the last step's hidden state and a torch-default Linear
head. Parameter names follow the reference torch layout (``layer_norm``,
``layer_lstm``, ``layer_linear``).

The LSTM keeps JAX's mixed precision (``nn/layers.py::LSTM``): f32 runs
``torch.lstm`` (cuDNN on the card), bf16 serving the step loop with f32
gates and cell state.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import LSTM, BatchNorm, Linear, avg_pool1d

POOL = 10


class LSTMModel(nn.Module):
    """(B, length, channels) windows to (B, out_features)."""

    def __init__(self, out_features: int, *, channels: int,
                 hidden: int = 512, generator: torch.Generator):
        super().__init__()
        self.layer_norm = BatchNorm(channels)
        self.layer_lstm = LSTM(channels, hidden, generator=generator)
        self.layer_linear = Linear(hidden, out_features, xavier=False,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = avg_pool1d(self.layer_norm(x), POOL)
        return self.layer_linear(self.layer_lstm(x)[:, -1])
