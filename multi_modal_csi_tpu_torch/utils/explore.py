"""Dataset exploration plots and statistics: the port's copy of the JAX
package's ``utils/explore.py``.

CSI amplitude heatmaps, window-length (packet-loss) statistics of the
amplitude cache, and the label distributions of an annotation. Where JAX
takes a pandas DataFrame, these take the port's
``data/annotation.py::Annotation`` (every cell a string, missing ones
``"nan"``) and return what JAX returns for the DataFrame that JAX's
``load_annotation`` reads from the same file. matplotlib is imported
inside the plotting functions, with its ``Agg`` backend.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..data.annotation import USER_ACTIVITY_COLS, Annotation


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def csi_heatmap(window: np.ndarray, save_path: Optional[str] = None,
                title: str = "CSI amplitude") -> None:
    """Time x (flattened antenna/subcarrier) amplitude heatmap for one
    window."""
    plt = _pyplot()
    flat = window.reshape(window.shape[0], -1)
    plt.figure(figsize=(12, 5))
    plt.imshow(flat.T, aspect="auto", origin="lower", cmap="viridis")
    plt.xlabel("packet (time)")
    plt.ylabel("rx x antenna x subcarrier")
    plt.title(title)
    plt.colorbar(label="|CSI|")
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path)
    plt.close()


def packet_loss_stats(amp_dir: str, labels: Sequence[str],
                      target_len: int = 3000) -> Dict[str, float]:
    """Window-length statistics: how much of each ``target_len``-step
    window is real data and how much left-pad (reference
    ``visualize.ipynb``'s per-band packet-loss analysis). Maps each
    ``.npy`` without reading its data (the JAX package's header reader,
    numpy's private ``_read_array_header``, is absent from some numpy
    versions)."""
    lengths = np.asarray([np.load(os.path.join(amp_dir, f"{label}.npy"),
                                  mmap_mode="r").shape[0]
                          for label in labels])
    loss = 1.0 - np.minimum(lengths, target_len) / target_len
    return {
        "num_windows": int(lengths.size),
        "mean_length": float(lengths.mean()),
        "min_length": int(lengths.min()),
        "max_length": int(lengths.max()),
        "mean_packet_loss": float(loss.mean()),
        "p95_packet_loss": float(np.percentile(loss, 95)),
        "windows_full": int((lengths >= target_len).sum()),
    }


def _value_counts(cells: np.ndarray) -> Dict[str, int]:
    """pandas' ``value_counts().to_dict()`` of a string column: missing
    cells left out, the most frequent first, ties in the order first
    met."""
    values, first, counts = np.unique(cells[cells != "nan"],
                                      return_index=True, return_counts=True)
    order = sorted(range(len(values)), key=lambda i: (-counts[i], first[i]))
    return {str(values[i]): int(counts[i]) for i in order}


def label_distribution(df: Annotation) -> Dict[str, Dict[str, int]]:
    """Counts per environment / wifi_band / number_of_users, and of each
    activity over the six users' columns."""
    out = {col: _value_counts(df[col])
           for col in ("environment", "wifi_band", "number_of_users")}
    acts: Dict[str, int] = {}
    for col in USER_ACTIVITY_COLS:
        for val, count in _value_counts(df[col]).items():
            acts[val] = acts.get(val, 0) + count
    out["activity"] = acts
    return out


def plot_label_distribution(df: Annotation, save_dir: str) -> None:
    """One bar chart per ``label_distribution`` entry,
    ``save_dir/dist_<key>.png``."""
    plt = _pyplot()
    dist = label_distribution(df)
    os.makedirs(save_dir, exist_ok=True)
    for key, counts in dist.items():
        plt.figure(figsize=(8, 4))
        names = list(counts.keys())
        plt.bar(range(len(names)), [counts[n] for n in names])
        plt.xticks(range(len(names)), names, rotation=45, ha="right")
        plt.title(f"samples per {key}")
        plt.tight_layout()
        plt.savefig(f"{save_dir}/dist_{key}.png")
        plt.close()
