"""Spectrogram features on the card, ST-RF's front end (counterpart of the
JAX package's ``kernels/spectrogram.py``, whose name it keeps; like that
module it holds no hand-written kernel, only tensor operations). The ST-RF
runner computes its features here, on the run's device.

``spectrogram`` is ``scipy.signal.spectrogram``'s default PSD over the last
axis at the reference's settings (``model/strf.py:55-56``): frames of
``NPERSEG`` steps every ``NPERSEG - NOVERLAP``, each frame's mean removed,
the periodic Tukey(``TUKEY_ALPHA``) window that scipy 1.15 and later
apply, ``torch.fft.rfft`` of ``NFFT`` points, |X|^2 scaled by the window's
energy, and the one-sided doubling of every bin but DC and Nyquist.
``strf_features`` is the whole feature pipeline: each window's
per-channel mean removed, the spectrogram over time, the mean over frames,
flattened to (N, C x 9).
"""

from __future__ import annotations

import numpy as np
import torch

NPERSEG, NOVERLAP, NFFT = 16, 8, 16
TUKEY_ALPHA = 0.25          # scipy's default window, tukey(m, 0.25)


def tukey_window(m: int, periodic: bool = False) -> np.ndarray:
    """``scipy.signal.windows.tukey(m, TUKEY_ALPHA)``; ``periodic`` gives
    ``tukey(m + 1)[:-1]``."""
    if periodic:
        return tukey_window(m + 1)[:-1]
    alpha = TUKEY_ALPHA
    n = np.arange(m)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    w = np.ones(m)
    left = n[:width + 1]
    w[:width + 1] = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * left / alpha
                                               / (m - 1))))
    right = n[-(width + 1):]
    w[-(width + 1):] = 0.5 * (1 + np.cos(np.pi * (
        -2.0 / alpha + 1 + 2.0 * right / alpha / (m - 1))))
    return w


def spectrogram(x: torch.Tensor) -> torch.Tensor:
    """One-sided PSD spectrogram of (..., T): (..., NFFT // 2 + 1,
    frames)."""
    frames = x.unfold(-1, NPERSEG, NPERSEG - NOVERLAP)   # (..., F, NPERSEG)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    window = tukey_window(NPERSEG, periodic=True)
    frames = frames * torch.as_tensor(window, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(frames, n=NFFT, dim=-1)
    psd = spec.real ** 2 + spec.imag ** 2
    mult = np.full(psd.shape[-1], 2.0)
    mult[0] = mult[-1] = 1.0                   # DC and Nyquist (NFFT even)
    mult /= float((window ** 2).sum())
    psd = psd * torch.as_tensor(mult, dtype=psd.dtype, device=psd.device)
    return psd.transpose(-1, -2)


def strf_features(x: torch.Tensor) -> torch.Tensor:
    """(N, T, C) windows to (N, C x (NFFT // 2 + 1)) averaged spectrogram
    features."""
    x = x - x.mean(dim=1, keepdim=True)
    ft = spectrogram(x.transpose(1, 2)).mean(dim=-1)     # (N, C, 9)
    return ft.reshape(ft.shape[0], -1)
