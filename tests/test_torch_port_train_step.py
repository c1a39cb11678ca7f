"""One training step of the port (train/loop.py::make_train_step) against
the JAX package's ``make_train_step``, on the CPU, in f32: THAT at a narrow
shape and DETR at ``dryrun_multichip``'s.

- THAT: (4, 1400, 70) windows, so both streams hold 70 tokens and pass the
  attention's flash gate of 64 (10 heads of 7). The port's gate runs
  ``flash_attention_trainable`` (K1 forward, K2 backward; their plain
  versions on the CPU) five times; JAX keeps its XLA attention on the CPU.
  BCE with pos_weight 4, weight decay 2e-4, lr 5e-4.
- DETR: (4, 300, 30) windows, 2 weight-shared decoder layers, FFN 64,
  Hungarian matching loss, weight decay 2e-4.

Both sides start from the same perturbed variables (the JAX tree carried
by ``state_dict_from_jax``), with augmentation off and dropout off: the
test process swaps ``flax.linen.Dropout`` for the identity and sets p = 0
on every port dropout. Compared:

- the loss, within 1e-5 relative;
- the gradients, within 1e-4 of each tensor's scale: its largest
  gradient, floored at 1e-2 of the model's largest. JAX's come from its
  Adam state: after one step mu = 0.1 (g + wd p), so g = mu / 0.1 - wd p.
  The floor is for tensors whose gradient is zero in exact arithmetic (a
  conv bias feeding a training BatchNorm, a LayerNorm bias feeding only
  such a conv) and float noise of up to 3e-7 in both frameworks;
- the BatchNorm running statistics, within 1e-5 absolute and relative;
- the updated parameters, within 1e-6 absolute, where g + wd p has the
  same sign in both frameworks and exceeds 1e-5 (a thousand times Adam's
  eps) in both. Adam's first step moves each weight by about
  lr sign(g + wd p), so where a gradient within float noise of zero takes
  the other sign in the other framework, the weight moves by up to 2 lr;
  those elements (counted and printed: 1177 of 548404 for THAT, 1735 of
  53074 for DETR, whose zero-gradient tensors fall there whole; under 5%)
  are held to 2 lr + 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.losses.matching import (
    HungarianMatchingLoss as JaxHungarian)
from multi_modal_csi_tpu.models.csi.detr import DETRMultiUser as JaxDETR
from multi_modal_csi_tpu.models.csi.that import THAT as JaxTHAT
from multi_modal_csi_tpu.train.loop import (
    adam_like_torch as jax_adam, make_train_step as jax_make_train_step)
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.kernels import flash_attention as FA
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.losses.matching import HungarianMatchingLoss
from multi_modal_csi_tpu_torch.models.csi import THAT, DETRMultiUser
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                  make_train_step)
from test_torch_port_layers import perturb

torch.set_num_threads(1)

LR, WD = 5e-4, 2e-4
THAT_SHAPE = (4, 1400, 70)
DETR_SHAPE = (4, 300, 30)
DETR_LAYERS = 2


class _NoDropout:
    """Stands in for flax.linen.Dropout: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


@pytest.fixture
def no_jax_dropout(monkeypatch):
    import flax.linen
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)


def no_dropout(model):
    """p = 0 on every dropout of a port model (layers and attention)."""
    for m in model.modules():
        if isinstance(m, (P.Dropout, P.MultiheadAttention)):
            setattr(m, "p" if isinstance(m, P.Dropout) else "dropout", 0.0)
    return model


def jax_variables(jmodel, shape, seed):
    """JAX's own initialisation of ``jmodel`` for windows of ``shape``,
    perturbed (numpy tree)."""
    x = np.zeros((1,) + shape[1:], np.float32)
    init = jmodel.init({"params": jax.random.PRNGKey(seed)}, x, train=False)
    return perturb(jax.tree_util.tree_map(np.asarray, init), seed)


def that_pair(seed=1):
    """JAX THAT and the port's at the narrow shape, on the same
    variables."""
    jmodel = JaxTHAT(out_features=54)
    variables = jax_variables(jmodel, THAT_SHAPE, seed)
    port = THAT(54, length=THAT_SHAPE[1], channels=THAT_SHAPE[2],
                generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax("THAT", variables), strict=True)
    return jmodel, variables, port


def detr_pair(seed=1):
    """JAX DETR and the port's at dryrun_multichip's shape, on the same
    variables."""
    jmodel = JaxDETR(token_length=10, num_decoder_layers=DETR_LAYERS,
                     num_queries=5, dim_feedforward=64)
    variables = jax_variables(jmodel, DETR_SHAPE, seed)
    port = DETRMultiUser(10, DETR_LAYERS, 1.0, 5, 64,
                         length=DETR_SHAPE[1], channels=DETR_SHAPE[2],
                         generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_jax(
        "DETR", variables, num_decoder_layers=DETR_LAYERS), strict=True)
    return jmodel, variables, port


def that_batch(seed=2, n=THAT_SHAPE[0]):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + THAT_SHAPE[1:], dtype=np.float32)
    y = (rng.random((n, 54)) < 0.2).astype(np.float32)
    return x, y


def detr_batch(seed=2, n=DETR_SHAPE[0]):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + DETR_SHAPE[1:], dtype=np.float32)
    cls = rng.integers(0, 10, size=(n, 5))
    y = np.eye(10, dtype=np.float32)[cls]
    return x, y


def jax_step(jmodel, variables, loss_fn, x, y):
    """JAX make_train_step once: (loss, new variables, gradients), all
    numpy; the gradients recovered from Adam's first moment."""
    tx = jax_adam(LR, WD)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    step = jax_make_train_step(jmodel, tx, loss_fn, augment=False)
    new_params, new_stats, opt_state, loss, _ = step(
        params, stats, opt_state, jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    mu = next(s.mu for s in opt_state if hasattr(s, "mu"))
    grads = jax.tree_util.tree_map(
        lambda m, p: np.asarray(m) / 0.1 - WD * np.asarray(p),
        mu, variables["params"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (float(loss), {"params": as_np(new_params),
                          "batch_stats": as_np(new_stats)}, grads)


def port_step(port, loss_fn, x, y):
    no_dropout(port)
    opt = adam_like_torch(port.parameters(), LR, WD)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    step = make_train_step(port, opt, loss_fn, augment=False)
    loss, _ = step(torch.from_numpy(x), torch.from_numpy(y),
                   torch.Generator().manual_seed(0))
    return float(loss), before


def compare(key, port, before, loss, jloss, jnew, jgrads, layers=6):
    """The assertions of the module docstring; returns the count of
    parameter elements held only to the 2 lr bound."""
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    want_new = state_dict_from_jax(key, jnew, num_decoder_layers=layers)
    want_g = state_dict_from_jax(key, {"params": jgrads,
                                       "batch_stats": jnew["batch_stats"]},
                                 num_decoder_layers=layers)
    params = dict(port.named_parameters())
    floor = 1e-2 * max(np.abs(want_g[n].numpy()).max() for n in params)
    flipped = total = 0
    for name, p in params.items():
        g, wg = p.grad.numpy(), want_g[name].numpy()
        scale = max(np.abs(wg).max(), floor)
        assert np.abs(g - wg).max() <= 1e-4 * scale, name
        p0 = before[name].numpy()
        mine, theirs = g + WD * p0, wg + WD * p0
        sure = ((np.sign(mine) == np.sign(theirs))
                & (np.minimum(np.abs(mine), np.abs(theirs)) > 1e-5))
        got, want = p.detach().numpy(), want_new[name].numpy()
        assert np.abs(got - want)[sure].max(initial=0) <= 1e-6, name
        assert np.abs(got - want).max() <= 2 * LR + 1e-6, name
        flipped += int((~sure).sum())
        total += sure.size
    sd = port.state_dict()
    for name in sd:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(),
                                       want_new[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
    assert flipped < 0.05 * total
    return flipped, total


def test_that_train_step_matches_jax(no_jax_dropout, monkeypatch):
    jmodel, variables, port = that_pair()
    x, y = that_batch()
    jloss, jnew, jgrads = jax_step(
        jmodel, variables, lambda o, t: jax_bce(o, t, 4.0), x, y)

    calls = {"trainable": 0, "backward": 0}
    real_fwd, real_bwd = P.flash_attention_trainable, FA.flash_attention_backward

    def fwd(*a):
        calls["trainable"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["backward"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(P, "flash_attention_trainable", fwd)
    monkeypatch.setattr(FA, "flash_attention_backward", bwd)
    loss, before = port_step(port, lambda o, t: bce_with_logits(o, t, 4.0),
                             x, y)
    assert calls == {"trainable": 5, "backward": 5}
    flipped, total = compare("THAT", port, before, loss, jloss, jnew,
                             jgrads)
    print(f"THAT step: {flipped} of {total} parameter elements below the "
          f"gradient floor")


def test_detr_train_step_matches_jax(no_jax_dropout, monkeypatch):
    jmodel, variables, port = detr_pair()
    x, y = detr_batch()
    jloss, jnew, jgrads = jax_step(jmodel, variables, JaxHungarian(), x, y)
    calls = []
    monkeypatch.setattr(P, "flash_attention_trainable",
                        lambda *a: calls.append(1))
    loss, before = port_step(port, HungarianMatchingLoss(), x, y)
    assert calls == []            # 10 tokens and 5 queries: eager branch
    # the shared decoder layer is one set of parameters for Adam
    assert len(list(port.parameters())) < len(
        [k for k in port.state_dict() if "running" not in k])
    flipped, total = compare("DETR", port, before, loss, jloss, jnew,
                             jgrads, layers=DETR_LAYERS)
    print(f"DETR step: {flipped} of {total} parameter elements below the "
          f"gradient floor")
