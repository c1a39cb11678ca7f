"""Model complexity report: parameter count and FLOPs (the port's
counterpart of the JAX package's ``utils/complexity.py``).

The parameter count equals the JAX package's: ``nn.Module.parameters()``
lists a shared module's tensors once, as the JAX tree holds the
weight-shared decoder layer once. The FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over one eval forward, which
counts matrix products, convolutions and attention only; the JAX package
reads XLA's cost analysis of the compiled program, which counts every
operation, so the two FLOP figures differ by design.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def parameter_count(model: nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def forward_flops(model: nn.Module, example_x: torch.Tensor) -> float:
    """FLOPs of one eval-mode forward on ``example_x``; NaN if counting
    fails. The forward runs with autograd on: the counter's module hooks
    refuse parameters seen under ``no_grad``."""
    from torch.utils.flop_counter import FlopCounterMode
    was_training = model.training
    try:
        model.eval()
        counter = FlopCounterMode(display=False)
        with counter:
            model(example_x)
        return float(counter.get_total_flops())
    except Exception:
        return float("nan")
    finally:
        model.train(was_training)


def complexity_report(model: nn.Module,
                      example_x: torch.Tensor) -> Dict[str, float]:
    return {"parameter": parameter_count(model),
            "flops": forward_flops(model, example_x)}
