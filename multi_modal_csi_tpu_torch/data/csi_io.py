"""CSI amplitude windows from the per-label ``.npy`` cache: the port's copy
of the JAX package's ``data/csi_io.py``.

Each label's (T, 3, 3, 30) float32 amplitude is left-padded with zeros to
``length`` time steps (reference ``wifi_csi/load_data.py:48-78``); a
window longer than ``length`` keeps its LAST ``length`` steps. The output
is allocated once and filled in place by a thread pool. The runner reads
the same arrays through the C++ loader (``data/native_loader.py``), which
falls back to this one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np


def load_csi_windows(amp_dir: str, labels: Sequence[str],
                     length: int = 3000, num_threads: int = 8) -> np.ndarray:
    """(N, length, *trailing) float32 windows for ``labels``, where
    ``trailing`` is the cached arrays' shape after time ((3, 3, 30) for
    WiMANS)."""
    paths = [os.path.join(amp_dir, f"{label}.npy") for label in labels]
    probe = (np.load(paths[0], mmap_mode="r") if paths
             else np.zeros((0, 3, 3, 30), np.float32))
    out = np.zeros((len(paths), length, *probe.shape[1:]), dtype=np.float32)

    def fill(i: int) -> None:
        arr = np.load(paths[i])
        t = min(arr.shape[0], length)
        out[i, length - t:] = arr[arr.shape[0] - t:]

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(fill, range(len(paths))))
    return out


def flatten_features(x: np.ndarray) -> np.ndarray:
    """(N, T, 3, 3, 30) -> (N, T, 270), the layout every sequence model
    takes."""
    return x.reshape(x.shape[0], x.shape[1], -1)
