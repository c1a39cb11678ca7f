"""The SSL (SimCLR) pretraining runner (counterpart of the JAX package's
``runners/ssl.py``; reference ``model/SSL_model.py:276-391``,
``train_ssl.py:16-91``, ``inference_only.py:47-90``).

Per repeat r, seeded r + 39: the model drawn from a generator with that
seed, Adam at ``cfg.nn.lr`` (no weight decay, no schedule), and each epoch
a ``np.random.default_rng(seed)`` shuffle in which every batch trains,
the partial final one included (the reference's DataLoader has no
drop_last, unlike the CSI engine). A step makes the two views of its batch
(``view_fn``, by default ``models/csi/ssl.py::two_views``), runs the
model in training composition and minimises ``ssl_loss``. After each
epoch one test batch goes through the online head (its subset accuracy
is what the reference prints). The final weights win, as the reference's
``saving_flag=False`` makes them. They are saved to ``save_path``
(a component file) when given, and the whole test set is scored through
the online head: subset accuracy and the classification report, with the
port's own ``metrics/classification.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.checkpoint import save_components
from ..core.config import CSI_CHANNELS, Config
from ..core.device import cudnn_f32, resolve_device
from ..metrics.classification import (accuracy_score, classification_report,
                                      predict_labels)
from ..models.csi.ssl import SSLModel, ssl_loss, two_views
from ..nn.layers import dropout_generator
from ..train.loop import adam_like_torch, eval_dataset, state_snapshot
from .csi import _layout, master_split, summarize

Split = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
ViewFn = Callable[[torch.Generator, torch.Tensor],
                  Tuple[torch.Tensor, torch.Tensor]]


def build_ssl(out_features: int, seed: int,
              channels: int = CSI_CHANNELS) -> SSLModel:
    """The SSL model of repeat seed ``seed``, on the CPU."""
    return SSLModel(out_features, channels=channels,
                    generator=torch.Generator().manual_seed(seed))


def run_ssl(cfg: Config, data: Optional[Split] = None,
            save_path: Optional[str] = None,
            history: Optional[List[Dict[str, float]]] = None,
            view_fn: Optional[ViewFn] = None,
            device: Optional[Union[str, torch.device]] = None
            ) -> Dict[str, Any]:
    """Run ``cfg.repeat`` SSL pretraining runs on ``device`` (the card
    unless told otherwise) and return the result dict. ``history``, when
    given, receives one record per (repeat, epoch): the epoch's mean
    training loss and the one-batch accuracy. ``view_fn(generator, bx) ->
    (v1, v2)`` replaces the random views."""
    device = resolve_device(device)
    if data is None:
        data = master_split(cfg, "raw")
    x_tr, x_te, y_tr, y_te = data
    x_tr, x_te = _layout(x_tr, "seq"), _layout(x_te, "seq")
    y_tr_flat = y_tr.reshape(y_tr.shape[0], -1).astype(np.float32)
    y_te_flat = y_te.reshape(y_te.shape[0], -1)
    out_dim = y_tr_flat.shape[-1]
    views = view_fn or two_views
    bs = cfg.nn.batch_size

    result: Dict[str, Any] = {}
    accuracies, times_train, times_test = [], [], []
    for r in range(cfg.repeat):
        seed = r + 39
        model = build_ssl(out_dim, seed, x_tr.shape[-1]).to(device)
        np_rng = np.random.default_rng(seed)
        generator = torch.Generator(device=device).manual_seed(seed)
        opt = adam_like_torch(model.parameters(), cfg.nn.lr)

        def step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
            model.train()
            v1, v2 = views(generator, bx)
            opt.zero_grad(set_to_none=True)
            with dropout_generator(generator):
                z1, z2, logits = model(v1, v2)
            loss, _ = ssl_loss(z1, z2, logits, by)
            with cudnn_f32():          # the convs' backward in full f32
                loss.backward()
            opt.step()
            return loss.detach()

        n = x_tr.shape[0]
        t0 = time.time()
        for epoch in range(cfg.nn.epoch):
            perm = np_rng.permutation(n)
            total, seen = torch.zeros((), device=device), 0
            for start in range(0, n, bs):
                idx = perm[start:start + bs]
                bx = torch.from_numpy(x_tr[idx]).to(device)
                by = torch.from_numpy(y_tr_flat[idx]).to(device)
                total += step(bx, by) * len(idx)
                seen += len(idx)
            # one test batch through the online head (train_ssl.py:54-67)
            model.eval()
            with torch.no_grad():
                logits = model(torch.from_numpy(x_te[:bs]).to(device),
                               inference=True).float().cpu().numpy()
            acc = accuracy_score(y_te_flat[:bs].astype(int),
                                 predict_labels(logits, cfg.nn.threshold))
            if history is not None:
                history.append({"repeat": r, "epoch": epoch,
                                "train_loss": float(total) / max(seen, 1),
                                "accuracy_batch": float(acc)})
        t1 = time.time()

        if save_path:                        # the final weights
            save_components(save_path, state_snapshot(model))
        logits = eval_dataset(model, x_te)
        pred = predict_labels(logits, cfg.nn.threshold)
        accuracies.append(accuracy_score(y_te_flat.astype(int), pred))
        result[f"repeat_{r}"] = classification_report(
            y_te_flat.astype(int), pred)
        times_train.append(t1 - t0)
        times_test.append(time.time() - t1)

    summarize(result, accuracies, times_train, times_test)
    return result
