"""MLP over flattened CSI windows (counterpart of the JAX package's
``models/csi/mlp.py``; reference ``wifi_csi/model/mlp.py``): BatchNorm over
the flattened (length x channels) features, Linear 256 -> 128 -> out with
ReLU and Dropout(0.1), xavier-uniform weights. Parameter names follow the
reference torch layout (``layer_norm``, ``layer_{i}``).

The model flattens its input, so it takes (B, length, channels) windows
as served and the runner's flat (B, length x channels) rows (the model
table's ``input_layout="flat"``) alike. At full width layer_0 takes
810,000 features, and int8 serving's default for MLP is w8
(``core/config.py``'s ``QUANT_DEFAULTS``): layer_0 and layer_1 then run
P1's bf16 x int8 product, each reading its bf16 activation as it is; the
54-wide head stays float. JAX's serving fold of the input BatchNorm into
layer_0 (``fold_input_norm``) comes with the export CLI (ROADMAP item
13b).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import BatchNorm, Dropout, Linear


class MLP(nn.Module):
    """(B, ...) windows of in_features values to (B, out_features)
    logits."""

    def __init__(self, out_features: int, *, in_features: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.layer_norm = BatchNorm(in_features)
        self.layer_0 = Linear(in_features, 256, generator=g)
        self.layer_1 = Linear(256, 128, generator=g)
        self.layer_2 = Linear(128, out_features, generator=g)
        self.dropout = Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x.flatten(1))
        x = self.dropout(torch.relu(self.layer_0(x)))
        x = self.dropout(torch.relu(self.layer_1(x)))
        return self.dropout(self.layer_2(x))
