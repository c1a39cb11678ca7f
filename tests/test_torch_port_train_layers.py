"""The port's layers in training mode against the JAX package's, on the
CPU: BatchNorm's batch statistics and running-statistic update (JAX's
torch-exact ``_TorchBNCore``), dropout, the attention's training gate
(``nn/layers.py:433-437`` of the JAX package) and its gradients, and
THAT's encoder block in training.

Inputs and weights are made with numpy from a seed. Tolerances are f32
ones: 1e-5 absolute for BatchNorm, 2e-5 for attention outputs, and
gradients within 1e-5 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.models.csi.that import (
    EncoderBlock as JEncoderBlock)
from multi_modal_csi_tpu.nn import layers as J
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.models.csi.that import EncoderBlock
from multi_modal_csi_tpu_torch.nn import layers as P
from test_torch_port_layers import gen, perturb, port_load, to_torch
from test_torch_port_train_step import no_dropout, no_jax_dropout  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(4, 40, 12), (16, 12)],
                         ids=["sequence", "flat"])
def test_batchnorm_training_matches_torch_exact_core(shape):
    """Output and both running statistics after one training step."""
    x = (3.0 + 2.0 * np.random.default_rng(0).standard_normal(shape)
         ).astype(np.float32)
    jmod = J.BatchNorm()
    v = perturb(jmod.init(jax.random.PRNGKey(0), x,
                          use_running_average=True))
    want, mutated = jmod.apply(v, x, use_running_average=False,
                               mutable=["batch_stats"])
    pmod = port_load(P.BatchNorm(12), W._bn, v, v["batch_stats"]).train()
    got = pmod(to_torch(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(pmod.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(pmod.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)


def test_batchnorm_training_gradient_matches_jax():
    x = np.random.default_rng(1).standard_normal((4, 20, 6)).astype(
        np.float32)
    seed = np.random.default_rng(2).standard_normal((4, 20, 6)).astype(
        np.float32)
    jmod = J.BatchNorm()
    v = perturb(jmod.init(jax.random.PRNGKey(0), x,
                          use_running_average=True))

    def loss(x):
        y, _ = jmod.apply(v, x, use_running_average=False,
                          mutable=["batch_stats"])
        return jnp.sum(y * seed)

    want = np.asarray(jax.grad(loss)(x))
    pmod = port_load(P.BatchNorm(6), W._bn, v, v["batch_stats"]).train()
    xt = to_torch(x).requires_grad_()
    (pmod(xt) * to_torch(seed)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_batchnorm_bf16_training_keeps_f32_statistics():
    bn = P.BatchNorm(8).train()
    for p in bn.parameters():
        p.data = p.data.to(torch.bfloat16)
    y = bn(torch.randn(4, 10, 8, generator=gen()).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert bn.running_var.dtype == bn.running_mean.dtype == torch.float32


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(p):
    x = torch.ones(200_000)
    y = P.dropout(x, p, gen(3))
    kept = y != 0
    # binomial standard deviation at n = 2e5 is under 0.0012
    assert abs(float(kept.float().mean()) - (1 - p)) < 0.006
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert torch.equal(y, P.dropout(x, p, gen(3)))       # same generator
    assert not torch.equal(y, P.dropout(x, p, gen(4)))


def test_dropout_off():
    x = torch.randn(5, 7, generator=gen())
    assert P.dropout(x, 0.0, gen()) is x
    assert torch.equal(P.dropout(x, 1.0, gen()), torch.zeros_like(x))
    layer = P.Dropout(0.5)
    assert layer.eval()(x) is x
    assert layer.train()(x) is not x
    assert P.Dropout(0.0).train()(x) is x


def test_dropout_generator_scope():
    """Masks inside ``dropout_generator`` come from its generator."""
    x = torch.ones(1000)
    layer = P.Dropout(0.3).train()
    with P.dropout_generator(gen(7)):
        a = layer(x)
    with P.dropout_generator(gen(7)):
        b = layer(x)
    assert torch.equal(a, b)
    assert P._GENERATOR is None


def _mha(n, dropout=0.0):
    x = np.random.default_rng(2).standard_normal((2, n, 24)).astype(
        np.float32)
    jmod = J.MultiheadAttention(24, 4)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x, x, x))
    pmod = port_load(P.MultiheadAttention(24, 4, dropout=dropout,
                                          generator=gen()), W._mha, v)
    return x, jmod, v, pmod


@pytest.mark.parametrize("n,dropout,training,branch", [
    (80, 0.0, True, "trainable"), (80, 0.1, True, "eager"),
    (80, 0.1, False, "flash"), (10, 0.0, True, "eager"),
    (10, 0.0, False, "eager")])
def test_mha_gate(n, dropout, training, branch, monkeypatch):
    """Training takes flash_attention_trainable exactly where JAX takes
    its trainable kernel: no mask, >= 64 tokens, attention dropout 0."""
    calls = []
    for name in ("flash_attention", "flash_attention_trainable"):
        real = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    x, _, _, pmod = _mha(n, dropout)
    xt = to_torch(x)
    pmod.train(training)
    with torch.no_grad():
        pmod(xt, xt, xt)
    want = {"trainable": ["flash_attention_trainable"],
            "flash": ["flash_attention"], "eager": []}[branch]
    assert calls == want


@pytest.mark.parametrize("n", [80, 10], ids=["trainable", "eager"])
def test_mha_training_gradients_match_jax(n):
    """Output and the gradients of sum(out * seed) with respect to the
    input and the packed projection, dropout 0, both branches."""
    x, jmod, v, pmod = _mha(n)
    seed = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def loss(params, x):
        out = jmod.apply({"params": params}, x, x, x, deterministic=False)
        return jnp.sum(out * seed), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(v["params"], x)
    xt = to_torch(x).requires_grad_()
    out = pmod.train()(xt, xt, xt)
    (out * to_torch(seed)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    for got, ref in ((xt.grad, gx),
                     (pmod.in_proj_weight.grad, gp["in_proj_weight"].T),
                     (pmod.out_proj.weight.grad, gp["out_proj_weight"].T)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max())


def test_eager_attention_dropout_uses_the_generator():
    x, _, _, pmod = _mha(10, dropout=0.5)
    xt = to_torch(x)
    pmod.train()
    with P.dropout_generator(gen(1)):
        a = pmod(xt, xt, xt)
    with P.dropout_generator(gen(1)):
        b = pmod(xt, xt, xt)
    with P.dropout_generator(gen(2)):
        c = pmod(xt, xt, xt)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_encoder_block_training_matches_jax(no_jax_dropout):
    """THAT's encoder layer in training, dropout off on both sides: the
    output, BN running statistics and the input gradient."""
    x = np.random.default_rng(4).standard_normal((2, 70, 30)).astype(
        np.float32)
    jmod = JEncoderBlock(30, 10, (1, 3, 5))
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))

    def loss(x):
        out, mut = jmod.apply(v, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), (out, mut)

    (_, (want, mut)), gx = jax.value_and_grad(loss, has_aux=True)(x)
    pmod = port_load(EncoderBlock(30, 10, (1, 3, 5), generator=gen()),
                     lambda sd, p, s, pre: W._encoder_block(sd, p, s, pre, 3),
                     v, v["batch_stats"])
    no_dropout(pmod).train()
    xt = to_torch(x).requires_grad_()
    out = pmod(xt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx,
                               atol=1e-5 * np.abs(gx).max())
    for i in range(3):
        stats = mut["batch_stats"][f"cnn_bn_{i}"]["bn"]
        bn = pmod.layer_cnn[i][1]
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-5)
