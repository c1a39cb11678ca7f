"""Multilabel classification scores without sklearn: the port's copies of
``sklearn.metrics.accuracy_score`` and ``classification_report(digits=6,
zero_division=0, output_dict=True)`` for the (n, labels) 0/1 indicator
arrays that the runner's final report passes them
(JAX ``runners/csi.py:200-210``).

The arithmetic is sklearn's (``precision_recall_fscore_support``):
precision tp / predicted, recall tp / true, F1 2 tp / (true + predicted),
each 0 where its denominator is 0; the micro average pools the counts, the
macro average is the mean over labels, the weighted average weighs labels
by their support (unweighted if every support is 0), and the samples
average is the mean of the same scores per sample.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _indicator(y_true: np.ndarray, y_pred: np.ndarray):
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if (y_true.ndim != 2 or y_true.shape != y_pred.shape
            or y_true.shape[1] < 2):
        raise ValueError("multilabel indicator arrays of one (n, labels) "
                         f"shape with labels >= 2 are needed, got "
                         f"{y_true.shape} and {y_pred.shape}")
    for a in (y_true, y_pred):
        if not np.isin(a, (0, 1)).all():
            raise ValueError("indicator arrays hold 0 and 1 only")
    return y_true.astype(bool), y_pred.astype(bool)


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Subset accuracy: the share of rows predicted exactly."""
    y_true, y_pred = _indicator(y_true, y_pred)
    return float(np.average(np.all(y_true == y_pred, axis=1)))


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    out = num / np.where(den == 0, 1.0, den)
    return np.where(den == 0, 0.0, out)


def _scores(tp, pred, true):
    return (_divide(tp, pred), _divide(tp, true),
            _divide(2.0 * tp, 1.0 * true + pred))


def classification_report(y_true: np.ndarray,
                          y_pred: np.ndarray) -> Dict[str, Dict[str, float]]:
    """sklearn's report dict: one entry per label ('0', '1', ...), then
    'micro avg', 'macro avg', 'weighted avg' and 'samples avg', each with
    'precision', 'recall', 'f1-score' and 'support' as floats."""
    y_true, y_pred = _indicator(y_true, y_pred)
    tp = (y_true & y_pred).sum(axis=0)
    pred = y_pred.sum(axis=0)
    true = y_true.sum(axis=0)
    p, r, f = _scores(tp, pred, true)
    support = float(true.sum())
    report = {str(i): {"precision": float(p[i]), "recall": float(r[i]),
                       "f1-score": float(f[i]), "support": float(true[i])}
              for i in range(len(tp))}

    def row(scores):
        return dict(zip(("precision", "recall", "f1-score"),
                        (float(s) for s in scores)), support=support)

    report["micro avg"] = row(_scores(tp.sum(), pred.sum(), true.sum()))
    report["macro avg"] = row((np.mean(p), np.mean(r), np.mean(f)))
    weights = true if true.sum() else None
    report["weighted avg"] = row(np.average(s, weights=weights)
                                 for s in (p, r, f))
    per_sample = _scores((y_true & y_pred).sum(axis=1), y_pred.sum(axis=1),
                         y_true.sum(axis=1))
    report["samples avg"] = row(np.mean(s) for s in per_sample)
    return report
