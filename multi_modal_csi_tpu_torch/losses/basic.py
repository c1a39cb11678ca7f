"""Elementary losses with the JAX package's numerics (``losses/basic.py``
there), which are torch's: BCEWithLogitsLoss(pos_weight), MSELoss,
SmoothL1Loss and CrossEntropyLoss(weight, label_smoothing), all reduced to
a mean, computed in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: Optional[float] = None) -> torch.Tensor:
    """Mean BCE-with-logits; ``pos_weight`` scales the positive term.

    Stable form: (1 - y) x + (1 + (pw - 1) y) softplus(-x).
    """
    x = logits.float()
    y = targets.float()
    sp = F.softplus(-x)
    if pos_weight is None:
        loss = (1.0 - y) * x + sp
    else:
        loss = (1.0 - y) * x + (1.0 + (pos_weight - 1.0) * y) * sp
    return loss.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred.float() - target.float()) ** 2).mean()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """torch.nn.SmoothL1Loss, mean reduction."""
    d = (pred.float() - target.float()).abs()
    loss = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return loss.mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  label_smoothing: float = 0.0,
                  reduction: str = "mean") -> torch.Tensor:
    """torch.nn.CrossEntropyLoss over integer class targets.

    Per sample: (1 - eps) w_y nll + eps / K sum_c w_c (-log p_c); "mean"
    divides by sum_n w_{y_n} (not by N) when weights are given.
    """
    logits = logits.float()
    num_classes = logits.shape[-1]
    log_p = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_p, -1, targets[..., None])[..., 0]
    if weight is not None:
        w = weight.float().to(logits.device)
        wy = w[targets]
        nll_term = wy * nll
        smooth_term = -(log_p * w).sum(dim=-1)
    else:
        wy = torch.ones_like(nll)
        nll_term = nll
        smooth_term = -log_p.sum(dim=-1)
    eps = label_smoothing
    loss = (1.0 - eps) * nll_term + (eps / num_classes) * smooth_term
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / wy.sum()
