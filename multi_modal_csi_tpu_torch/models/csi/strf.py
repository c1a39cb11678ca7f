"""ST-RF: spectrogram features and a random forest, the one CSI model
without a network (counterpart of the JAX package's
``models/csi/strf.py``; reference ``wifi_csi/model/strf.py:17-113``).

The features are the reference's: each window centred per channel, the
spectrogram (nperseg 16, noverlap 8, nfft 16) over time, the mean over
frames. The runner computes them with ``kernels/spectrogram.py::
strf_features`` on its device (``device_features``), a few windows at a
time; ``spectrogram_features`` is the reference's own scipy pipeline on
the host, which the JAX runner uses and which the tests and
``chip_smoke.py`` hold the torch features against. The forest is
sklearn's multi-output ``RandomForestClassifier`` (10 trees, no
bootstrap, seeded r + 39) on the host. sklearn is imported inside
``fit_predict_strf``, so the module imports where sklearn is absent; ST-RF
runs wherever it is installed.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
from scipy import signal

from ...kernels.spectrogram import strf_features

FEATURE_CHUNK = 64     # windows moved to the device at a time


def spectrogram_features(x: np.ndarray) -> np.ndarray:
    """(N, T, C) CSI windows to (N, C x 9) averaged spectrogram features,
    with scipy on the host."""
    x = x - x.mean(axis=1, keepdims=True)
    xt = np.swapaxes(x, -1, -2)                        # (N, C, T)
    _, _, ft = signal.spectrogram(xt, noverlap=8, nperseg=16, nfft=16)
    ft = ft.mean(axis=-1)
    return ft.reshape(ft.shape[0], -1)


def device_features(x: np.ndarray,
                    device: Union[str, torch.device]) -> np.ndarray:
    """``strf_features`` of (N, T, C) host windows computed on ``device``,
    ``FEATURE_CHUNK`` windows at a time, returned on the host."""
    return np.concatenate([
        strf_features(torch.from_numpy(x[i:i + FEATURE_CHUNK]).to(device))
        .cpu().numpy() for i in range(0, len(x), FEATURE_CHUNK)])


def fit_predict_strf(f_train: np.ndarray, y_train: np.ndarray,
                     f_test: np.ndarray, seed: int) -> np.ndarray:
    """Train the forest on the training windows' features and return its
    (flat, multi-output) predictions for the test windows' features."""
    try:
        from sklearn.ensemble import RandomForestClassifier
    except ImportError as e:
        raise ImportError("ST-RF's random forest needs sklearn, which is "
                          "not installed") from e
    model = RandomForestClassifier(n_estimators=10, random_state=seed,
                                   bootstrap=False)
    model.fit(f_train, y_train.reshape(y_train.shape[0], -1))
    return np.asarray(model.predict(f_test))
