"""Performance plots (the port of the JAX package's ``utils/visualize.py``;
reference ``wifi_csi/utils.py:289-391``): per-class count histograms,
per-class confusion matrices, the per-sample error distribution,
class-wise MAE bars and a predicted-against-true scatter, saved as PNGs;
returns the summary statistics. matplotlib is imported inside
``visualize_model_performance`` only, and the confusion matrices are
counted with numpy.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..metrics.performance import threshold_round


def _to_counts(y_pred: np.ndarray, y_true: np.ndarray,
              var_mode: str) -> Tuple[np.ndarray, np.ndarray]:
    """Mode-specific predictions and targets as per-activity counts."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    if var_mode == "count_classification_withConstrain":
        return y_pred, y_true
    if var_mode == "multi_head":
        if y_pred.ndim == 4:
            y_pred = y_pred[-1]
        num_classes = y_pred.shape[-1]
        idx = np.argmax(y_pred, axis=-1)
        return (np.eye(num_classes)[idx].sum(axis=1)[:, :-1],
                y_true.sum(axis=1)[:, :-1])
    if var_mode == "count_classification":
        return np.clip(threshold_round(y_pred, 0.3), 0, 5), y_true
    if var_mode == "baseline":
        y_pred = (1 / (1 + np.exp(-y_pred)) > 0.5).astype(float)
        y_true = y_true.reshape(y_true.shape[0], -1, 9)
        return y_pred.reshape(y_true.shape).sum(axis=1), y_true.sum(axis=1)
    raise ValueError(f"unsupported var_mode: {var_mode}")


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    """sklearn's confusion matrix: rows true, columns predicted, over the
    sorted values either side takes."""
    labels = np.unique(np.concatenate([y_true, y_pred]))
    t, p = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    cm = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def visualize_model_performance(y_pred, y_true, save_dir="./visualizations",
                                var_mode="multi_head") -> Dict[str, object]:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y_pred, y_true = _to_counts(y_pred, y_true, var_mode)
    os.makedirs(save_dir, exist_ok=True)
    n_classes = int(y_pred.shape[1])
    cols = (n_classes + 1) // 2

    plt.figure(figsize=(15, 5))
    for i in range(n_classes):
        plt.subplot(2, cols, i + 1)
        plt.hist(y_true[:, i], alpha=0.5, label="Ground Truth", bins=range(7))
        plt.hist(y_pred[:, i], alpha=0.5, label="Predicted", bins=range(7))
        plt.title(f"Class {i}")
        if i == 0:
            plt.legend()
    plt.tight_layout()
    plt.savefig(f"{save_dir}/count_distributions_{var_mode}.png")
    plt.close()

    fig, axes = plt.subplots(2, cols, figsize=(20, 8))
    for i in range(n_classes):
        ax = axes[i // cols, i % cols]
        cm = confusion_matrix(y_true[:, i], np.round(y_pred[:, i]))
        ax.imshow(cm, cmap="Blues")
        for (r, c), v in np.ndenumerate(cm):
            ax.text(c, r, str(v), ha="center", va="center", fontsize=8)
        ax.set_title(f"Class {i}")
    plt.tight_layout()
    plt.savefig(f"{save_dir}/confusion_matrices_{var_mode}.png")
    plt.close()

    errors = np.abs(y_pred - y_true).mean(axis=1)
    plt.figure(figsize=(10, 6))
    plt.hist(errors, bins=30)
    plt.title("Distribution of Mean Absolute Error per Sample")
    plt.savefig(f"{save_dir}/error_distribution_{var_mode}.png")
    plt.close()

    class_errors = np.abs(y_pred - y_true).mean(axis=0)
    plt.figure(figsize=(10, 6))
    plt.bar(range(n_classes), class_errors)
    plt.title("Mean Absolute Error by Class")
    plt.savefig(f"{save_dir}/class_errors_{var_mode}.png")
    plt.close()

    plt.figure(figsize=(10, 10))
    for i in range(n_classes):
        plt.scatter(y_true[:, i], y_pred[:, i], alpha=0.1, label=f"Class {i}")
    plt.plot([0, 5], [0, 5], "r--")
    plt.legend()
    plt.savefig(f"{save_dir}/prediction_scatter_{var_mode}.png")
    plt.close()

    return {
        "class_wise_mae": class_errors.tolist(),
        "mean_error": float(errors.mean()),
        "error_std": float(errors.std()),
        "perfect_predictions": float(
            (np.abs(y_pred - y_true) < 0.5).all(axis=1).mean()),
    }
