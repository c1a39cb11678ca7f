"""One training step of each of the port's WiMANS baselines against the
JAX package's, on the CPU, in f32, at test_torch_port_csi_baselines.py's
sizes and weights.

- One step per model (``make_train_step``), as
  test_torch_port_train_step.py holds THAT's and DETR's: BCE with the
  model's pos_weight (MSE for CNN-1D), lr 5e-4, weight decay 2e-4, batch
  4, augmentation off and dropout off on both sides; the loss within 1e-5
  relative, every gradient within 1e-4 of its tensor's scale, the updated
  parameters within 1e-6 where Adam's step has a sure sign (else 2 lr),
  the BatchNorm running statistics within 1e-5. LSTM's step runs
  torch.lstm's backward on the port's side and JAX's scan on the other.
  The elements whose g + wd p is under 1e-5 in either package are held to
  2 lr only; their share must stay under ``MAX_UNSURE`` (5% as for THAT
  and DETR, more where small gradients are common at these sizes: the
  LSTM hidden weights' median gradient is 1e-5 and CNN-1D's last conv's
  8e-5; measured 15.5% LSTM, 10.6% ABLSTM, 15.9% CLSTM, 20.7% CNN-1D).
  Among all of them, at most 4 elements per tensor take the other sign in
  the other package.

``fit`` is held in test_torch_port_csi_baselines_fit.py.
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.losses.basic import mse as jax_mse
from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS
from multi_modal_csi_tpu_torch.core.config import Config
from test_torch_port_csi_baselines import KEYS, OUT, pair, windows
from test_torch_port_train_step import (compare, jax_step,  # noqa: F401
                                        no_jax_dropout, port_step)

torch.set_num_threads(1)

POS_WEIGHT = {"MLP": 4.0, "LSTM": 6.0, "CNN-2D": 6.0, "CLSTM": 8.0,
              "ABLSTM": 6.0}
MAX_UNSURE = {"LSTM": 0.2, "ABLSTM": 0.15, "CLSTM": 0.2, "CNN-1D": 0.25}


def losses(key):
    """(JAX loss, port loss) of the model table."""
    if key == "CNN-1D":
        return jax_mse, CSI_MODELS[key].make_loss(Config(), OUT)
    pw = POS_WEIGHT[key]
    return (lambda o, t: jax_bce(o, t, pw),
            CSI_MODELS[key].make_loss(Config(), OUT))


def labelled(key, n, seed):
    """Windows and one-active-user labels (one of the 54 outputs on)."""
    x = windows(key, n=n, seed=seed)
    y = np.zeros((n, OUT), np.float32)
    y[np.arange(n), np.random.default_rng(seed + 100).integers(0, OUT, n)] = 1
    return x, y


@pytest.mark.parametrize("key", KEYS)
def test_train_step_matches_jax(no_jax_dropout, key):
    jmodel, variables, port = pair(key)
    x, y = labelled(key, 4, seed=11)
    jloss_fn, loss_fn = losses(key)
    jloss, jnew, jgrads = jax_step(jmodel, variables, jloss_fn, x, y)
    loss, before = port_step(port, loss_fn, x, y)
    flipped, total = compare(key, port, before, loss, jloss, jnew, jgrads,
                             max_unsure=MAX_UNSURE.get(key, 0.05))
    print(f"{key} step: {flipped} of {total} parameter elements below the "
          f"gradient floor")
