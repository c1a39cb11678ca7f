"""Set-matching losses (counterpart of the JAX package's
``losses/matching.py``).

For Q <= 8 queries the minimal-cost assignment is found by enumerating the
Q! permutations in lexicographic order and taking the FIRST minimum, as
``jnp.argmin`` does, on the tensors' device; larger Q goes to scipy's
``linear_sum_assignment`` on the host. The selection runs without
gradients, like the reference's no-grad matching; the loss is then
differentiated through the selected pairs.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional

import numpy as np
import torch

from .basic import cross_entropy, smooth_l1

_MAX_ENUM_QUERIES = 8  # 8! = 40320 rows


@functools.cache
def _permutations(q: int) -> np.ndarray:
    return np.array(list(itertools.permutations(range(q))), dtype=np.int64)


def permutation_table(q: int, device=None) -> torch.Tensor:
    """(Q!, Q) int64 table of all permutations, lexicographic order."""
    if q > _MAX_ENUM_QUERIES:
        raise NotImplementedError(
            f"exact enumeration supports up to {_MAX_ENUM_QUERIES} queries; "
            f"got {q} (hungarian_assignment solves larger Q on the host)")
    return torch.from_numpy(_permutations(q)).to(device)


def _host_lap(cost: torch.Tensor) -> torch.Tensor:
    """Batched scipy linear_sum_assignment: (B, Q, Q) -> (B, Q)."""
    from scipy.optimize import linear_sum_assignment
    c = cost.detach().float().cpu().numpy()
    cols = np.stack([linear_sum_assignment(m)[1] for m in c])
    return torch.from_numpy(cols.astype(np.int64)).to(cost.device)


@torch.no_grad()
def hungarian_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Minimal-cost assignment for a batch of square cost matrices.

    cost: (B, Q, Q), rows are predictions, columns targets. Returns col_ind
    (B, Q): row q goes to column col_ind[b, q]. Ties take the first
    permutation in lexicographic order (Q <= 8) or scipy's choice.
    """
    q = cost.shape[-1]
    if q > _MAX_ENUM_QUERIES:
        return _host_lap(cost)
    perms = permutation_table(q, cost.device)                   # (P, Q)
    # total[b, p] = sum_q cost[b, q, perms[p, q]]
    rows = torch.arange(q, device=cost.device)
    total = cost[:, rows[None, :], perms].sum(dim=-1)           # (B, P)
    return perms[torch.argmin(total, dim=-1)]                   # (B, Q)


def class_imbalance_weights(num_classes: int,
                            last_class_weight: float) -> torch.Tensor:
    """DETR CE weights: "no-person" (the last class) down-weighted, then
    renormalised to mean 1."""
    w = np.ones(num_classes, dtype=np.float32)
    w[-1] = last_class_weight
    w = w * (len(w) / w.sum())
    return torch.from_numpy(w)


def _matched_ce(pred: torch.Tensor, tgt_classes: torch.Tensor,
                col_ind: torch.Tensor, weight: Optional[torch.Tensor],
                label_smoothing: float) -> torch.Tensor:
    """Weighted CE of the matched (query -> target) pairs, averaged
    torch-style within each sample, then over the batch."""
    matched = torch.gather(tgt_classes, 1, col_ind)             # (B, Q)
    per = cross_entropy(pred, matched, weight=weight,
                        label_smoothing=label_smoothing, reduction="none")
    if weight is not None:
        wy = weight.to(pred.device)[matched]
        per_sample = per.sum(dim=1) / wy.sum(dim=1)
    else:
        per_sample = per.mean(dim=1)
    return per_sample.mean()


def _match_indices(layer_logits: torch.Tensor, tgt_classes: torch.Tensor,
                   cost_class_weight: float) -> torch.Tensor:
    """Hungarian column indices for one layer's logits, without gradient."""
    with torch.no_grad():
        prob = torch.softmax(layer_logits.float(), dim=-1)
        # cost[b, q, j] = -prob[b, q, class of target j]
        cost = -torch.gather(
            prob, 2, tgt_classes[:, None, :].expand(-1, prob.shape[1], -1))
        return hungarian_assignment(cost * cost_class_weight)


class HungarianMatchingLoss:
    """DETR-style set loss.

    outputs: [L, B, Q, C] per-decoder-layer logits (or [B, Q, C]);
    targets: [B, Q, C] one-hot rows (class C-1 = "no-person"). The final
    layer's matching weights every auxiliary layer unless
    ``per_layer_matching``, which matches each layer on its own (the
    THAT_ENCODER variant). CE with class-imbalance weights and label
    smoothing, torch's weighted-mean normalisation.
    """

    def __init__(self, cost_class_weight: float = 1.0,
                 aux_loss_weight: float = 0.25,
                 label_smoothing: float = 0.3,
                 class_imbalance_weight: float = 0.25,
                 num_classes: int = 10,
                 per_layer_matching: bool = False):
        self.cost_class_weight = float(cost_class_weight)
        self.aux_loss_weight = float(aux_loss_weight)
        self.label_smoothing = float(label_smoothing)
        self.per_layer_matching = bool(per_layer_matching)
        self.weight = class_imbalance_weights(num_classes,
                                              class_imbalance_weight)

    def __call__(self, outputs: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
        squeeze = outputs.dim() == 3
        if squeeze:
            outputs = outputs[None]
        tgt_classes = torch.argmax(targets, dim=-1)              # (B, Q)

        def layer_loss(layer, col_ind=None):
            if col_ind is None:
                col_ind = _match_indices(layer, tgt_classes,
                                         self.cost_class_weight)
            return _matched_ce(layer, tgt_classes, col_ind, self.weight,
                               self.label_smoothing)

        final = outputs[-1]
        col_ind = _match_indices(final, tgt_classes, self.cost_class_weight)
        final_loss = layer_loss(final, col_ind)
        if squeeze or outputs.shape[0] == 1:
            return final_loss
        shared = None if self.per_layer_matching else col_ind
        aux = torch.stack([layer_loss(layer, shared)
                           for layer in outputs[:-1]])
        return final_loss + self.aux_loss_weight * aux.mean()


def permutation_matching_loss(predictions: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """THAT_MULTI_HEAD loss: the head permutation with the least mean CE
    per sample (chosen without gradient), then the mean CE of the permuted
    predictions over the batch.

    predictions: (B, H, C) head logits; targets: (B, H, C) one-hots.
    """
    h = predictions.shape[1]
    log_p = torch.log_softmax(predictions.float(), dim=-1)
    tgt = torch.argmax(targets, dim=-1)                          # (B, H)
    # nll[b, i, j] = CE(pred head i, target j)
    nll = -torch.gather(log_p, 2, tgt[:, None, :].expand(-1, h, -1))
    perms = permutation_table(h, predictions.device)             # (P, H)
    cols = torch.arange(h, device=predictions.device)
    diag = nll[:, perms, cols[None, :]]                          # (B, P, H)
    with torch.no_grad():
        best = torch.argmin(diag.mean(dim=-1), dim=-1)           # (B,)
    best_nll = diag[torch.arange(diag.shape[0], device=diag.device), best]
    return best_nll.mean()


def count_based_loss(predictions: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """THAT_COUNT_CONSTRAINED loss: SmoothL1 between the summed per-person
    probabilities and the summed count targets."""
    return smooth_l1(predictions, targets)
