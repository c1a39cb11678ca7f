"""The transfer-learning optimizer (counterpart of the JAX package's
``train/transfer.py``; reference ``wifi_csi/utils.py:16-86``): per
top-level submodule learning rates and freezing.

- ``full``: one Adam over every parameter at lr;
- ``feature_extractor``: ``feature_extractor`` at lr x 0.01, the rest at
  lr;
- ``feature_encoder``: ``feature_extractor`` frozen, ``encoder`` at
  lr x 0.1, the rest at lr.

Adam without weight decay and without a schedule, each parameter's
moments starting from zero. A frozen submodule's parameters stay out of
the optimizer and stop asking for gradients; the module stays in training
mode, so its BatchNorm running statistics still update, as under JAX's
``optax.set_to_zero``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from .loop import adam_like_torch

SCENARIO_LR: Dict[str, Dict[str, float]] = {
    "full": {},
    "feature_extractor": {"feature_extractor": 0.01},
    "feature_encoder": {"feature_extractor": 0.0, "encoder": 0.1},
}


def transfer_optimizer(model: nn.Module, lr: float,
                       scenario: str = "full") -> torch.optim.Adam:
    """Adam over ``model``'s parameters with one group per top-level
    submodule that ``scenario`` scales (in the order ``named_children``
    gives), and one for the rest at ``lr``."""
    if scenario not in SCENARIO_LR:
        raise ValueError(f"unknown scenario: {scenario}")
    multipliers = SCENARIO_LR[scenario]
    rest: List[nn.Parameter] = []
    groups = []
    for name, child in model.named_children():
        params = list(child.parameters())
        if name not in multipliers:
            rest += params
        elif multipliers[name] == 0.0:
            for p in params:
                p.requires_grad_(False)
        else:
            groups.append({"params": params, "lr": lr * multipliers[name]})
    rest += list(model.parameters(recurse=False))
    if rest:
        groups.append({"params": rest, "lr": lr})
    return adam_like_torch(groups, lr)
