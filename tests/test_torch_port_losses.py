"""The port's losses, schedule, batching and metrics (losses/,
train/schedules.py, train/augment.py, data/pipeline.py, metrics/) against
the JAX package's, on the CPU, on numpy-seeded inputs.

Tolerances: losses and their gradients within 1e-6 relative (f32 sums of
a few hundred terms taken in another order); the schedule within 1e-6
relative (JAX computes it in f32, the port in f64); assignments, batch
indices and metrics exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.data import pipeline as JP
from multi_modal_csi_tpu.losses import basic as JB
from multi_modal_csi_tpu.losses import matching as JM
from multi_modal_csi_tpu.metrics.performance import (
    performance_metrics as jax_metrics)
from multi_modal_csi_tpu.train.schedules import (
    cosine_warmup as jax_cosine_warmup)
from multi_modal_csi_tpu_torch.data import pipeline as PP
from multi_modal_csi_tpu_torch.losses import basic as PB
from multi_modal_csi_tpu_torch.losses import matching as PM
from multi_modal_csi_tpu_torch.metrics.performance import (
    performance_metrics as port_metrics)
from multi_modal_csi_tpu_torch.train.augment import apply_augmentation
from multi_modal_csi_tpu_torch.train.schedules import cosine_warmup

torch.set_num_threads(1)

REL = 1e-6


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _loss_and_grad(port_fn, jax_fn, logits, *rest):
    """Value and gradient with respect to the logits, in both packages."""
    jv, jg = jax.value_and_grad(lambda x: jax_fn(x, *rest))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    tr = [torch.from_numpy(r) if isinstance(r, np.ndarray) else r
          for r in rest]
    pv = port_fn(t, *tr)
    pv.backward()
    return (float(pv.detach()), t.grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("pos_weight", [None, 4.0])
def test_bce_with_logits(rng, pos_weight):
    x = rng.normal(size=(16, 54)).astype(np.float32) * 3
    y = (rng.random((16, 54)) < 0.3).astype(np.float32)
    (pv, pg), (jv, jg) = _loss_and_grad(
        PB.bce_with_logits, JB.bce_with_logits, x, y, pos_weight)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("name", ["mse", "smooth_l1"])
def test_regression_losses(rng, name):
    x = rng.normal(size=(16, 9)).astype(np.float32) * 2
    y = rng.normal(size=(16, 9)).astype(np.float32)
    (pv, pg), (jv, jg) = _loss_and_grad(getattr(PB, name),
                                        getattr(JB, name), x, y)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("smoothing", [0.0, 0.3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy(rng, smoothing, weighted, reduction):
    x = rng.normal(size=(8, 5, 10)).astype(np.float32)
    t = rng.integers(0, 10, size=(8, 5))
    w = rng.uniform(0.2, 2.0, 10).astype(np.float32) if weighted else None
    want = JB.cross_entropy(jnp.asarray(x), jnp.asarray(t),
                            None if w is None else jnp.asarray(w),
                            smoothing, reduction)
    got = PB.cross_entropy(torch.from_numpy(x), torch.from_numpy(t),
                           None if w is None else torch.from_numpy(w),
                           smoothing, reduction)
    _close(got.numpy(), want)


def test_hungarian_assignment_matches_jax(rng):
    cost = rng.normal(size=(32, 5, 5)).astype(np.float32)
    got = PM.hungarian_assignment(torch.from_numpy(cost)).numpy()
    want = np.asarray(JM.hungarian_assignment(jnp.asarray(cost)))
    np.testing.assert_array_equal(got, want)


def test_hungarian_first_minimum_tie_rule():
    """Equal totals take the first permutation in lexicographic order, as
    jnp.argmin does: all-equal costs give the identity, and a cost that
    ties two of the permutations gives the earlier one."""
    flat = np.zeros((1, 5, 5), np.float32)
    # zero cost on exactly two assignments, (1, 0, 2) and (2, 1, 0)
    tie = np.ones((1, 3, 3), np.float32)
    for r, c in ((0, 1), (1, 0), (2, 2), (0, 2), (1, 1), (2, 0)):
        tie[0, r, c] = 0.0
    for cost in (flat, tie):
        got = PM.hungarian_assignment(torch.from_numpy(cost)).numpy()
        want = np.asarray(JM.hungarian_assignment(jnp.asarray(cost)))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PM.hungarian_assignment(torch.from_numpy(flat)).numpy(),
        [[0, 1, 2, 3, 4]])
    np.testing.assert_array_equal(
        PM.hungarian_assignment(torch.from_numpy(tie)).numpy(),
        [[1, 0, 2]])


def test_hungarian_q9_goes_to_scipy(rng):
    cost = rng.normal(size=(3, 9, 9)).astype(np.float32)
    got = PM.hungarian_assignment(torch.from_numpy(cost)).numpy()
    want = np.asarray(JM.hungarian_assignment(jnp.asarray(cost)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        PM.permutation_table(9)


def test_permutation_table_and_class_weights():
    np.testing.assert_array_equal(PM.permutation_table(4).numpy(),
                                  np.asarray(JM._permutation_table(4)))
    np.testing.assert_array_equal(
        PM.class_imbalance_weights(10, 0.25).numpy(),
        np.asarray(JM.class_imbalance_weights(10, 0.25)))


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("layers", [1, 6])
def test_hungarian_matching_loss(rng, per_layer, layers):
    """Value and gradient over the stacked per-layer logits; with one
    layer the (B, Q, C) form too."""
    x = rng.normal(size=(layers, 16, 5, 10)).astype(np.float32) * 2
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=(16, 5))]
    if layers == 1:
        x = x[0]
    port = PM.HungarianMatchingLoss(per_layer_matching=per_layer)
    jaxl = JM.HungarianMatchingLoss(per_layer_matching=per_layer)
    (pv, pg), (jv, jg) = _loss_and_grad(port, jaxl, x, y)
    _close(pv, jv)
    _close(pg, jg)


def test_permutation_matching_loss(rng):
    x = rng.normal(size=(16, 5, 10)).astype(np.float32) * 2
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=(16, 5))]
    (pv, pg), (jv, jg) = _loss_and_grad(
        PM.permutation_matching_loss, JM.permutation_matching_loss, x, y)
    _close(pv, jv)
    _close(pg, jg)


def test_count_based_loss(rng):
    x = rng.random((16, 10)).astype(np.float32) * 5
    y = rng.integers(0, 5, size=(16, 10)).astype(np.float32)
    (pv, pg), (jv, jg) = _loss_and_grad(
        PM.count_based_loss, JM.count_based_loss, x, y)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.05),
                                                (0, 50, 0.1), (30, 40, 0.2)])
def test_cosine_warmup_matches_jax(warmup, total, floor):
    port = cosine_warmup(warmup, total, floor)
    jsched = jax_cosine_warmup(5e-4, warmup, total, floor)
    for step in range(0, total + 5):
        _close(5e-4 * port(step), float(jsched(step)))
    assert port(0) == (0.0 if warmup else 1.0)


def test_cosine_warmup_through_lambda_lr():
    """Stepped once per optimizer step, update t uses multiplier(t):
    the first update's lr is 0 in warmup, as with optax."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=5e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_warmup(4, 20, 0.1))
    jsched = jax_cosine_warmup(5e-4, 4, 20, 0.1)
    for t in range(20):
        _close(opt.param_groups[0]["lr"], float(jsched(t)))
        opt.step()
        sched.step()


@pytest.mark.parametrize("n,bs,skip", [(100, 16, True), (96, 16, True),
                                       (100, 16, False), (5, 16, True)])
def test_epoch_batches_identical_to_jax(n, bs, skip):
    for epoch_seed in (0, 39):
        got = PP.epoch_batches(n, bs, np.random.default_rng(epoch_seed),
                               skip_last=skip)
        want = JP.epoch_batches(n, bs, np.random.default_rng(epoch_seed),
                                skip_last=skip)
        np.testing.assert_array_equal(got, want)


def test_chunked_and_pad_to(rng):
    assert PP.chunked(1030, 512) == JP.chunked(1030, 512)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_array_equal(PP.pad_to(a, 8), JP.pad_to(a, 8))
    assert PP.pad_to(a, 3) is a


def test_prefetch_batches_on_cpu(rng):
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y = rng.normal(size=(10, 2)).astype(np.float32)
    idx = PP.epoch_batches(10, 4, np.random.default_rng(0))
    out = list(PP.prefetch_batches(x, y, idx, torch.device("cpu")))
    assert len(out) == 2
    for (bx, by), row in zip(out, idx):
        np.testing.assert_array_equal(bx.numpy(), x[row])
        np.testing.assert_array_equal(by.numpy(), y[row])


def _metric_inputs(mode, rng):
    if mode == "baseline":
        return ((rng.random((40, 54)) < 0.2).astype(np.float32),
                rng.normal(size=(40, 54)).astype(np.float32) * 2)
    if mode == "multi_head":
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=(40, 5))]
        return y, rng.normal(size=(6, 40, 5, 10)).astype(np.float32)
    if mode == "count_classification":
        return (rng.integers(0, 3, size=(40, 9)).astype(np.float32),
                rng.random((40, 9)).astype(np.float32) * 3)
    return (rng.integers(0, 3, size=(40, 10)).astype(np.float32),
            rng.integers(0, 3, size=(40, 10)).astype(np.float32))


@pytest.mark.parametrize("mode", ["baseline", "multi_head",
                                  "count_classification",
                                  "count_classification_withConstrain"])
def test_metrics_copy_equals_jax(mode, rng):
    y, pred = _metric_inputs(mode, rng)
    got = port_metrics(y, pred, var_mode=mode, var_threshold=0.5)
    want = jax_metrics(y, pred, var_mode=mode, var_threshold=0.5)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))


def test_augmentation_statistics():
    """Noise sigma 0.1, per-sample scale in [0.9, 1.1), keep rate 0.96,
    all from the generator given."""
    x = torch.zeros(4, 500, 100)
    g = torch.Generator().manual_seed(0)
    noise = apply_augmentation(x, g)
    nonzero = noise[noise != 0]
    assert abs(float(nonzero.std()) - 0.1) < 0.01
    assert abs(float((noise == 0).float().mean()) - 0.04) < 0.005
    big = apply_augmentation(torch.full((64, 400, 1), 100.0),
                             torch.Generator().manual_seed(1))
    # mean of a sample's kept elements / 100: its scale, +-1e-4 of noise
    scale = big.sum(dim=(1, 2)) / (big != 0).sum(dim=(1, 2)) / 100.0
    assert float(scale.min()) > 0.9 - 1e-3 and float(scale.max()) < 1.1 + 1e-3
    assert float(scale.max() - scale.min()) > 0.15
    same = apply_augmentation(x, torch.Generator().manual_seed(0))
    assert torch.equal(noise, same)
