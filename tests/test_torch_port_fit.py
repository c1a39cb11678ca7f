"""The port's ``fit`` (train/loop.py) against the JAX package's, on the CPU,
epoch by epoch: THAT at the narrow (n, 1400, 70) shape, activity head,
BCE pos_weight 4, lr 5e-5, weight decay 2e-4, batch 4, 2 epochs, the same
seed on both sides (so the same shuffles), augmentation off and dropout
off (flax.linen.Dropout swapped for the identity in this process, p = 0 on
the port's dropouts), both starting from the same variables.

12 training windows give 2 steps an epoch (the last batch is skipped);
10 validation windows are evaluated in full each epoch. Each window's
label holds one active user with one activity.

Compared per epoch: train and validation loss within 1e-4 relative; the
discrete metrics (validation PPP, total error and F1, train PPP) equal;
and the same best epoch.

Why lr 5e-5 and not the preset's 5e-4: Adam's first steps move each weight
by about lr sign(g), and a gradient within float noise of zero can take
the other sign in the other framework (test_torch_port_train_step.py
counts those weights), so such weights drift apart by up to 2 lr a step.
At 5e-4 that alone moved the second epoch's training loss by 4.3e-4
relative; the drift scales with lr.
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.train.loop import fit as jax_fit
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.models.csi import THAT
from multi_modal_csi_tpu_torch.train.loop import FitResult, fit
from test_torch_port_train_step import (THAT_SHAPE, no_dropout,  # noqa: F401
                                        no_jax_dropout, that_pair)

torch.set_num_threads(1)

SETTINGS = dict(mode="baseline", lr=5e-5, epochs=2, batch_size=4, seed=0,
                weight_decay=2e-4, augment=False)


def one_user_windows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + THAT_SHAPE[1:], dtype=np.float32)
    y = np.zeros((n, 54), np.float32)
    y[np.arange(n), rng.integers(0, 54, size=n)] = 1.0
    return x, y


def test_that_fit_matches_jax_per_epoch(no_jax_dropout):
    jmodel, variables, port = that_pair()
    x_tr, y_tr = one_user_windows(12, seed=3)
    x_va, y_va = one_user_windows(10, seed=4)
    want = jax_fit(jmodel, x_tr, y_tr, x_va, y_va,
                   loss_fn=lambda o, t: jax_bce(o, t, 4.0),
                   init_variables=(variables["params"],
                                   variables["batch_stats"]), **SETTINGS)
    got = fit(no_dropout(port), x_tr, y_tr, x_va, y_va,
              loss_fn=lambda o, t: bce_with_logits(o, t, 4.0),
              device="cpu", **SETTINGS)
    assert got.epochs_ran == want.epochs_ran == 2
    assert got.best_epoch == want.best_epoch
    for mine, theirs in zip(got.history, want.history):
        for key in ("train_loss", "test_loss"):
            assert mine[key] == pytest.approx(theirs[key], rel=1e-4), key
        for key in ("perfect_prediction_percentage_test",
                    "perfect_prediction_percentage_train",
                    "total_error_test", "f1_score"):
            assert mine[key] == theirs[key], key
        print({k: (mine[k], theirs[k]) for k in ("train_loss", "test_loss",
                                                 "f1_score")})


def test_fit_train_dtype_bf16():
    """fit(train_dtype="bfloat16"): parameters in bf16 (Adam makes its
    moments in their dtype), BatchNorm running statistics f32, batches
    cast, validation in bf16 with f32 logits, finite losses; an unknown
    dtype is refused."""
    x, y = one_user_windows(12, seed=5)
    model = THAT(54, length=THAT_SHAPE[1], channels=THAT_SHAPE[2],
                 generator=torch.Generator().manual_seed(0))
    res = fit(model, x, y, x[:6], y[:6],
              loss_fn=lambda o, t: bce_with_logits(o, t, 4.0),
              device="cpu", train_dtype="bfloat16",
              **dict(SETTINGS, epochs=1, augment=True))
    assert isinstance(res, FitResult) and res.epochs_ran == 1
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    stats = [v for k, v in res.best_state.items() if "running" in k]
    assert stats and all(s.dtype == torch.float32 for s in stats)
    assert all(v.device.type == "cpu" for v in res.best_state.values())
    assert np.isfinite(res.history[0]["train_loss"])
    assert np.isfinite(res.history[0]["test_loss"])

    with pytest.raises(ValueError, match="train_dtype"):
        fit(model, x, y, x, y, loss_fn=bce_with_logits, device="cpu",
            train_dtype="fp8", **SETTINGS)


def test_fit_needs_a_full_batch():
    x, y = one_user_windows(4, seed=6)
    model = THAT(54, length=THAT_SHAPE[1], channels=THAT_SHAPE[2],
                 generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no full batch"):
        fit(model, x, y, x, y, loss_fn=bce_with_logits, device="cpu",
            **SETTINGS)
