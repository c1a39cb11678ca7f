"""The dual-band runner (counterpart of the JAX package's
``runners/dual_band.py``; reference ``run_dualband.py:34-129``,
``model/dual_band.py:174-233``): paired 2.4 GHz and 5 GHz windows through
``DualBandCNN``.

``load_dual_band_data`` selects the two bands independently
(``cfg.data`` and ``cfg.data_band2``), pairs them by position and takes
the labels from band 1; band 2's windows go to band 2's tower (the
reference passes band 1's windows to both, a fault the JAX package
fixed). ``run_dual_band`` trains each repeat through ``train.loop.fit``
(BCE with pos_weight 6, baseline metrics, the test split as validation),
then scores the test set with the best weights: subset accuracy and the
classification report.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import CSI_CHANNELS, Config
from ..losses.basic import bce_with_logits
from ..metrics.classification import (accuracy_score, classification_report,
                                      predict_labels)
from ..models.csi.dual_band import DualBandCNN
from ..train.loop import eval_dataset, fit
from .csi import _layout, master_split, summarize

Split = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def build_dual_band(out_features: int, seed: int,
                    channels: int = CSI_CHANNELS) -> DualBandCNN:
    """The dual-band model of repeat seed ``seed``, on the CPU."""
    return DualBandCNN(out_features, channels=channels,
                       generator=torch.Generator().manual_seed(seed))


def load_dual_band_data(cfg: Config) -> Split:
    """(x_tr, x_te, y_tr, y_te) with x of (n, 2, length, channels): band 1
    from ``cfg.data``, band 2 from ``cfg.data_band2``, paired by position
    and cut to the shorter; the labels are band 1's."""
    x1_tr, x1_te, y_tr, y_te = master_split(cfg, "raw", data_cfg=cfg.data)
    x2_tr, x2_te, _, _ = master_split(cfg, "raw", data_cfg=cfg.data_band2)
    n_tr, n_te = min(len(x1_tr), len(x2_tr)), min(len(x1_te), len(x2_te))
    x_tr = np.stack([_layout(x1_tr[:n_tr], "seq"),
                     _layout(x2_tr[:n_tr], "seq")], axis=1)
    x_te = np.stack([_layout(x1_te[:n_te], "seq"),
                     _layout(x2_te[:n_te], "seq")], axis=1)
    return x_tr, x_te, y_tr[:n_tr], y_te[:n_te]


def run_dual_band(cfg: Config, data: Optional[Split] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Dict[str, Any]:
    """Run ``cfg.repeat`` seeded dual-band experiments on ``device`` (the
    card unless told otherwise) and return the result dict."""
    if data is None:
        data = load_dual_band_data(cfg)
    x_tr, x_te, y_tr, y_te = data
    y_tr_flat = y_tr.reshape(y_tr.shape[0], -1)
    y_te_flat = y_te.reshape(y_te.shape[0], -1)
    out_dim = y_tr_flat.shape[-1]

    result: Dict[str, Any] = {}
    accuracies, times_train, times_test = [], [], []
    for r in range(cfg.repeat):
        model = build_dual_band(out_dim, r + 39, x_tr.shape[-1])
        t0 = time.time()
        fitres = fit(model, x_tr, y_tr_flat, x_te, y_te_flat,
                     loss_fn=lambda o, t: bce_with_logits(o, t, 6.0),
                     mode="baseline", lr=cfg.nn.lr, epochs=cfg.nn.epoch,
                     batch_size=cfg.nn.batch_size, seed=r + 39,
                     threshold=cfg.nn.threshold, patience=cfg.nn.patience,
                     device=device)
        t1 = time.time()
        model.load_state_dict(fitres.best_state)
        logits = eval_dataset(model, x_te)
        pred = predict_labels(logits, cfg.nn.threshold)
        accuracies.append(accuracy_score(y_te_flat.astype(int), pred))
        result[f"repeat_{r}"] = classification_report(
            y_te_flat.astype(int), pred)
        times_train.append(t1 - t0)
        times_test.append(time.time() - t1)

    summarize(result, accuracies, times_train, times_test)
    return result
