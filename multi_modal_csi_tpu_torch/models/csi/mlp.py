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
54-wide head stays float.

Serving (JAX's ``models/csi/mlp.py:48``): ``fold_input_norm=True`` builds
the model without the input BatchNorm, for a state dict that
``fold_input_norm`` has folded it into layer_0 (exact eval-mode algebra;
the export CLI folds by default). Training keeps the live BatchNorm.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from ...nn.layers import BatchNorm, Dropout, Linear

StateDict = Dict[str, torch.Tensor]


class MLP(nn.Module):
    """(B, ...) windows of in_features values to (B, out_features)
    logits."""

    def __init__(self, out_features: int, *, in_features: int,
                 fold_input_norm: bool = False,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.layer_norm = None if fold_input_norm else BatchNorm(in_features)
        self.layer_0 = Linear(in_features, 256, generator=g)
        self.layer_1 = Linear(256, 128, generator=g)
        self.layer_2 = Linear(128, out_features, generator=g)
        self.dropout = Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.flatten(1)
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        x = self.dropout(torch.relu(self.layer_0(x)))
        x = self.dropout(torch.relu(self.layer_1(x)))
        return self.dropout(self.layer_2(x))


def bn_affine(state: Mapping[str, torch.Tensor], prefix: str):
    """An eval-mode BatchNorm as x a + c, in float64: a = weight /
    sqrt(running_var + 1e-5), c = bias - running_mean a (the eps of the
    port's ``BatchNorm`` here, and of JAX's folds)."""
    weight, bias, mean, var = (state[f"{prefix}.{name}"].double() for name in
                               ("weight", "bias", "running_mean",
                                "running_var"))
    a = weight / torch.sqrt(var + 1e-5)
    return a, bias - mean * a


def fold_input_norm(state: Mapping[str, torch.Tensor]) -> StateDict:
    """Fold MLP's eval-mode input BatchNorm into layer_0, as JAX's
    ``fold_input_norm`` does (in float64, then float32): layer_0(x a + c)
    = x (W a) + (W c + b). Returns the state dict of an
    ``MLP(fold_input_norm=True)``: no ``layer_norm.*``, layer_0 folded."""
    a, c = bn_affine(state, "layer_norm")
    sd = {k: v for k, v in state.items() if not k.startswith("layer_norm.")}
    w0 = state["layer_0.weight"].double()             # (256, in)
    sd["layer_0.weight"] = (w0 * a).float()
    sd["layer_0.bias"] = (state["layer_0.bias"].double() + w0 @ c).float()
    return sd
