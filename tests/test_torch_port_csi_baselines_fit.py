"""The port's ``fit`` (train/loop.py) for the WiMANS baselines MLP (flat
windows), CNN-1D and LSTM against the JAX package's, on the CPU, for one
epoch, as test_torch_port_fit.py holds THAT's: the weights and sizes of
test_torch_port_csi_baselines.py, lr 5e-5, weight decay 2e-4, batch 4, 12
training windows (2 steps) and 10 validation windows with one active
user each, the same seed, augmentation and dropout off on both sides.
Compared: the training and validation losses within 1e-4 relative, the
discrete metrics (validation PPP, total error and F1, train PPP) equal,
and the same best epoch.

``run_csi_model`` for MLP (the flat layout, the classification report)
and CNN-1D (count_round) in both packages from one reference-layout .pt,
as test_torch_port_runner.py holds THAT_ENCODER's: every metric equal.
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu.train.loop import fit as jax_fit
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.train.loop import fit
from test_torch_port_csi_baselines import pair
from test_torch_port_csi_baselines_train import labelled, losses
from test_torch_port_runner import perturbed
from test_torch_port_train_step import no_dropout, no_jax_dropout  # noqa: F401

torch.set_num_threads(1)

FIT = dict(mode="baseline", lr=5e-5, epochs=1, batch_size=4, seed=0,
           weight_decay=2e-4, augment=False)


@pytest.mark.parametrize("key", ["MLP", "CNN-1D", "LSTM"])
def test_fit_matches_jax_per_epoch(no_jax_dropout, key):
    jmodel, variables, port = pair(key)
    x_tr, y_tr = labelled(key, 12, seed=3)
    x_va, y_va = labelled(key, 10, seed=4)
    jloss_fn, loss_fn = losses(key)
    want = jax_fit(jmodel, x_tr, y_tr, x_va, y_va, loss_fn=jloss_fn,
                   init_variables=(variables["params"],
                                   variables["batch_stats"]), **FIT)
    got = fit(no_dropout(port.train()), x_tr, y_tr, x_va, y_va,
              loss_fn=loss_fn, device="cpu", **FIT)
    assert got.epochs_ran == want.epochs_ran == 1
    assert got.best_epoch == want.best_epoch
    for mine, theirs in zip(got.history, want.history):
        for name in ("train_loss", "test_loss"):
            assert mine[name] == pytest.approx(theirs[name], rel=1e-4), name
        for name in ("perfect_prediction_percentage_test",
                     "perfect_prediction_percentage_train",
                     "total_error_test", "f1_score"):
            assert mine[name] == theirs[name], name


def raw_data(shape, n_tr=10, n_te=8, seed=4):
    """(x_tr, x_te, y_tr, y_te): ``shape`` windows and raw (n, 6, 9)
    activity one-hots of 0 to 5 users."""
    rng = np.random.default_rng(seed)
    n = n_tr + n_te
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = np.zeros((n, 6, 9), np.float32)
    for i in range(n):
        k = int(rng.integers(0, 6))
        y[i, :k] = np.eye(9, dtype=np.float32)[rng.integers(0, 9, size=k)]
    return x[:n_tr], x[n_tr:], y[:n_tr], y[n_tr:]


@pytest.mark.parametrize("key,shape", [("MLP", (60, 20)),
                                       ("CNN-1D", (393, 20))])
def test_run_csi_model_matches_jax_from_one_checkpoint(tmp_path, key,
                                                        shape):
    """run_csi_model in both packages from one reference-layout .pt with
    nn.epoch 0, so the final test pass runs the restored weights in f32:
    MLP through the flat layout and the classification report, CNN-1D
    through count_round; every metric equal."""
    overrides = {"model": key, "repeat": 1, "nn.epoch": 0,
                 "nn.batch_size": 4, "transfer_scenario": "full",
                 "pretrained_path": str(tmp_path / "weights.pt")}
    data = raw_data(shape)
    xs = (shape[0] * shape[1],) if key == "MLP" else shape
    model = perturbed(runner.CSI_MODELS[key].build(
        xs, 54, Config(), torch.Generator().manual_seed(5)), seed=6)
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    got = runner.run_csi_model(Config().override(overrides), data,
                               device="cpu")
    want = jax_runner.run_csi_model(JaxConfig().override(overrides), data)
    assert set(got) == set(want)
    assert ("final_metrics" in got) == (key == "CNN-1D")
    assert got["complexity"]["parameter"] == want["complexity"]["parameter"]
    for section in ("repeat_0", "accuracy") + (
            ("final_metrics",) if key == "CNN-1D" else ()):
        assert set(got[section]) == set(want[section]), section
        for name, value in want[section].items():
            if isinstance(value, dict):
                for metric, v in value.items():
                    assert got[section][name][metric] == pytest.approx(
                        v, rel=1e-12, abs=1e-15), f"{section}.{name}"
            else:
                np.testing.assert_array_equal(got[section][name], value,
                                              err_msg=f"{section}.{name}")
