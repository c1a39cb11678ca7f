"""Multi-user counting metric suite: the port's own copy of the JAX
package's ``metrics/performance.py`` (pure numpy, no JAX), every quirk
kept.

Numerically exact re-implementation of the reference's metric vocabulary
(wifi_csi/utils.py:103-270): total_error, perfect_prediction_percentage,
accuracy/precision/recall/F1 over activity-count vectors, mean_count_error,
error_per_person[1..5], for the four evaluation modes
{baseline, multi_head, count_classification, count_classification_withConstrain}.

Kept in pure numpy: these run on tiny (batch, 9/10) count vectors each epoch;
the heavy work (the forward pass producing the logits) stays on the card. The
quirks that move reported numbers are preserved on purpose:
  - the `+1e-6` denominators inside otherwise-guarded divisions
    (utils.py:206-208);
  - threshold_round rounding UP only when the decimal part is strictly greater
    than the threshold (utils.py:137-145);
  - baseline mode thresholding the per-user max prob at 0.5 regardless of the
    `var_threshold` argument (utils.py:238).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def threshold_round(x: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """Round up iff the decimal part exceeds `threshold` (utils.py:137-145)."""
    x = np.asarray(x, dtype=np.float64)
    decimal = x - np.floor(x)
    return np.where(decimal > threshold, np.ceil(x), np.floor(x))


def error_per_number_person(y_pred: np.ndarray, y_true: np.ndarray) -> List[float]:
    """Mean count-vector L1 error grouped by true #people 1..5 (utils.py:103-120).

    Groups with no samples yield NaN (np.mean of empty slice), matching the
    reference's behavior.
    """
    count_people = y_true.sum(axis=1)
    err = np.abs(y_pred - y_true).sum(axis=1)
    out = []
    for k in range(1, 6):
        sel = err[count_people == k]
        with np.errstate(invalid="ignore"):
            out.append(float(sel.mean()) if sel.size else float("nan"))
    return out


def count_error(y_pred: np.ndarray, y_true: np.ndarray) -> np.ndarray:
    """|sum(pred counts) - sum(true counts)| per sample (utils.py:122-134)."""
    return np.abs(y_pred.sum(axis=1) - y_true.sum(axis=1))


def process_predictions(y_pred: np.ndarray, y_true: np.ndarray,
                        var_threshold: float = 0.5):
    """Baseline-mode prediction pipeline (utils.py:147-183).

    Per user: argmax over the 9 activities; count it only if its probability
    exceeds `var_threshold`. Returns per-activity count vectors.
    """
    max_idx = np.argmax(y_pred, axis=2)                              # (N, U)
    max_prob = np.take_along_axis(y_pred, max_idx[..., None], axis=2)[..., 0]
    above = max_prob > var_threshold
    one_hot = np.zeros_like(y_pred)
    b = np.arange(y_pred.shape[0])[:, None]
    u = np.arange(y_pred.shape[1])[None, :]
    one_hot[b, u, max_idx] = above
    return one_hot.sum(axis=1), y_true.sum(axis=1), y_true.shape[0]


def calculate_scores(y_true: np.ndarray, y_pred: np.ndarray):
    """Per-activity P/R/F1/accuracy from count TP/FP/FN (utils.py:196-211)."""
    tp = np.minimum(y_true, y_pred)
    tn = np.where(np.maximum(y_true, y_pred) == 0, 1, 0)
    fp = np.maximum(0, y_pred - y_true)
    fn = np.maximum(0, y_true - y_pred)
    tp_a, tn_a = tp.sum(axis=0), tn.sum(axis=0)
    fp_a, fn_a = fp.sum(axis=0), fn.sum(axis=0)
    precision = np.where(tp_a + fp_a > 0, tp_a / (tp_a + fp_a + 1e-6), 0)
    recall = np.where(tp_a + fn_a > 0, tp_a / (tp_a + fn_a + 1e-6), 0)
    f1 = np.where(precision + recall > 0,
                  2 * precision * recall / (precision + recall + 1e-6), 0)
    accuracy = (tp_a + tn_a) / (tp_a + fn_a + tn_a + fp_a)
    return precision.mean(), recall.mean(), f1.mean(), accuracy.mean()


def performance_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                        var_mode: str = "multi_head",
                        var_threshold: float = 0.5) -> Dict[str, object]:
    """Mode-dispatched metric computation (utils.py:213-270).

    Modes:
      multi_head: y_pred is [L, B, Q, C] per-decoder-layer logits; the final
        layer's per-query argmax one-hots are summed to counts; the last
        ("no-person") class is dropped from both sides.
      count_classification: y_pred is per-activity expected counts;
        threshold_round(0.5) then clip to [0, 5].
      count_classification_withConstrain: y_pred already is count
        probabilities; compared directly.
      baseline: y_pred is (B, U*C) logits; sigmoid -> per-user argmax with
        0.5 prob gate -> counts.
    """
    y_true = np.array(y_true)
    y_pred = np.array(y_pred)

    if var_mode == "count_classification_withConstrain":
        batch_size = y_pred.shape[0]
    elif var_mode == "multi_head":
        # [L, B, Q, C] per-layer stacks use the final layer; (B, H, C) head
        # outputs (THAT_MULTI_HEAD) are used directly — the reference's
        # unconditional y_pred[-1] crashes on 3-D input (utils.py:221-222,
        # reference drift like SURVEY.md §2.6)
        if y_pred.ndim == 4:
            y_pred = y_pred[-1]
        batch_size, _, num_classes = y_pred.shape
        idx = np.argmax(y_pred, axis=-1)
        y_pred = np.eye(num_classes)[idx].sum(axis=1)
        y_true = y_true.sum(axis=1)
        y_pred = y_pred[:, :-1]
        y_true = y_true[:, :-1]
    elif var_mode == "count_classification":
        batch_size = y_pred.shape[0]
        y_pred = np.clip(threshold_round(y_pred, threshold=0.5), 0, 5)
    elif var_mode == "baseline":
        y_pred = (1.0 / (1.0 + np.exp(-y_pred))).astype(float)
        # the reference hardcodes 9 activity classes (utils.py:236) and
        # therefore breaks on identity/location labels; infer the per-user
        # class count from the label width instead (9 activities, 5
        # locations, 1 identity bit — all per 6 users)
        flat = y_true.reshape(y_true.shape[0], -1)
        classes = next((c for c in (9, 5, 1) if flat.shape[1] % (6 * c) == 0
                        and flat.shape[1] // c >= 1), 9)
        y_true = flat.reshape(flat.shape[0], -1, classes)
        y_pred = y_pred.reshape(y_true.shape[0], y_true.shape[1], y_true.shape[2])
        y_pred, y_true, batch_size = process_predictions(y_pred, y_true, 0.5)
    else:
        raise ValueError(f"unsupported var_mode: {var_mode}")

    diff = np.abs(y_true - y_pred)
    perfect = np.all(diff == 0, axis=1).sum()
    counting = count_error(y_pred, y_true)
    precision, recall, f1, acc = calculate_scores(y_true, y_pred)
    return {
        "total_error": diff.sum() / batch_size,
        "perfect_prediction_percentage": perfect / batch_size * 100,
        "accuracy": acc,
        "error_per_person": error_per_number_person(y_pred, y_true),
        "mean_count_error": counting.mean(),
        "counting_error_perPerson": counting,
        "precision": precision,
        "recall": recall,
        "f1_score": f1,
    }
