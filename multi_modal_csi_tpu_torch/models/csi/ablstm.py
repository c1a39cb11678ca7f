"""ABLSTM: an attention-weighted bidirectional LSTM (counterpart of the JAX
package's ``models/csi/ablstm.py``; reference ``wifi_csi/model/ablstm.py``):
BatchNorm, an average pool of 8 over time (3000 -> 375 steps), a
bidirectional LSTM(512), per-step scores from Linear(1024 -> 1024) and
LeakyReLU, a softmax over TIME, the score-weighted sum of the hidden
states, Dropout(0.6) and a Linear head; xavier Linear weights. Parameter
names follow the reference torch layout (``layer_norm``,
``layer_bilstm``, ``layer_linear`` for the scores, ``layer_output``).

The LSTM keeps JAX's mixed precision (``nn/layers.py::LSTM``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import (LSTM, BatchNorm, Dropout, Linear, avg_pool1d,
                          leaky_relu)

POOL = 8


class ABLSTM(nn.Module):
    """(B, length, channels) windows to (B, out_features)."""

    def __init__(self, out_features: int, *, channels: int,
                 hidden: int = 512, generator: torch.Generator):
        super().__init__()
        g = generator
        self.layer_norm = BatchNorm(channels)
        self.layer_bilstm = LSTM(channels, hidden, bidirectional=True,
                                 generator=g)
        self.layer_linear = Linear(2 * hidden, 2 * hidden, generator=g)
        self.dropout = Dropout(0.6)
        self.layer_output = Linear(2 * hidden, out_features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = avg_pool1d(self.layer_norm(x), POOL)
        h = self.layer_bilstm(x)                               # (B, L, 2H)
        a = torch.softmax(leaky_relu(self.layer_linear(h)), dim=-2)
        t = (h * a).sum(dim=-2)
        return self.layer_output(self.dropout(t))
