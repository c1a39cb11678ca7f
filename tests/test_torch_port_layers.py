"""Layers of the PyTorch port (multi_modal_csi_tpu_torch.nn, THAT's
GaussianPosition and EncoderBlock) against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed; the JAX module applies
the variables, the port module loads them through core/weights.py's maps.
Tolerances are f32 ones: 1e-5 absolute for single layers, 2e-5 where the
layer contains attention or a conv bank.

The helpers here are shared with the other test_torch_port_* files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.models.csi.that import (
    EncoderBlock as JEncoderBlock, GaussianPosition as JGaussianPosition)
from multi_modal_csi_tpu.nn import layers as J
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.models.csi.that import (EncoderBlock,
                                                       GaussianPosition)
from multi_modal_csi_tpu_torch.nn import layers as P

torch.set_num_threads(1)


def perturb(tree, seed=1):
    """Numpy copy of a JAX variables tree with non-trivial values: BN
    running stats away from (0, 1), scales away from 1, zero-initialised
    biases made non-zero, sigmas kept positive."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict) or hasattr(node, "items"):
            return {k: leaf(k, v) if not hasattr(v, "items") else walk(v)
                    for k, v in node.items()}
        raise TypeError(type(node))

    def leaf(name, a):
        a = np.asarray(a, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "mean":
            return 0.1 * noise
        if name == "sigma":
            return a * rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * noise
        return a + 0.02 * noise

    return walk(tree)


def port_load(module, fill, variables, *stats):
    """Load ``variables`` into a port module through one of
    core/weights.py's per-layer maps (``fill(sd, params, [stats,] pre)``)."""
    holder = torch.nn.ModuleDict({"m": module})
    sd = {}
    fill(sd, variables["params"], *stats, "m")
    holder.load_state_dict(sd, strict=True)
    return module.eval()


def run(module, *args, **kw):
    """The port module's forward without autograd."""
    with torch.no_grad():
        return module(*args, **kw)


def to_torch(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def x_seq():
    return np.random.default_rng(0).standard_normal(
        (2, 40, 12)).astype(np.float32)


@pytest.mark.parametrize("kernel", [1, 2, 3, 5])
def test_conv1d_same_padding(kernel, x_seq):
    """"SAME" with an even kernel pads (0, 1), as XLA does."""
    jmod = J.Conv1d(7, kernel, padding="SAME", xavier=False)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x_seq))
    want = np.asarray(jmod.apply(v, x_seq))
    pmod = port_load(P.Conv1d(12, 7, kernel, padding="SAME", xavier=False,
                              generator=gen()), W._conv1d, v)
    assert pmod.pads(40) == ((kernel - 1) // 2, kernel // 2)
    got = run(pmod, to_torch(x_seq)).numpy()
    assert got.shape == want.shape == (2, 40, 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=4, dilation=4),          # DETR dilated block
    dict(kernel_size=7, padding=3, groups=12),           # depthwise
    dict(kernel_size=8, stride=8),                       # DETR final conv
    dict(kernel_size=16),                                # THAT left cnn
], ids=["dilated", "depthwise", "strided", "valid"])
def test_conv1d_padding_dilation_stride_groups(kw, x_seq):
    jkw = {"features": 12 if kw.get("groups") else 5,
           "kernel_size": kw["kernel_size"], "stride": kw.get("stride", 1),
           "padding": kw.get("padding", "VALID"),
           "dilation": kw.get("dilation", 1),
           "feature_group_count": kw.get("groups", 1), "xavier": False}
    jmod = J.Conv1d(**jkw)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x_seq))
    want = np.asarray(jmod.apply(v, x_seq))
    pmod = port_load(P.Conv1d(12, jkw["features"], generator=gen(), **kw),
                     W._conv1d, v)
    got = run(pmod, to_torch(x_seq)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_linear(x_seq):
    jmod = J.Linear(9, xavier=True)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x_seq))
    pmod = port_load(P.Linear(12, 9, generator=gen()), W._linear, v)
    np.testing.assert_allclose(run(pmod, to_torch(x_seq)).numpy(),
                               np.asarray(jmod.apply(v, x_seq)), atol=1e-5)


def test_batchnorm_eval_running_stats(x_seq):
    jmod = J.BatchNorm()
    v = perturb(jmod.init(jax.random.PRNGKey(0), x_seq,
                          use_running_average=True))
    want = np.asarray(jmod.apply(v, x_seq, use_running_average=True))
    pmod = port_load(P.BatchNorm(12), W._bn, v, v["batch_stats"])
    np.testing.assert_allclose(run(pmod, to_torch(x_seq)).numpy(), want,
                               atol=1e-5)


def test_batchnorm_refuses_training_mode(x_seq):
    """Training mode no longer refuses: it normalises with the batch's
    statistics (zero mean, unit variance per feature), not the running
    ones, and moves the running ones. tests/test_torch_port_train_layers.py
    holds it against the JAX package's torch-exact core."""
    bn = P.BatchNorm(12).train()
    with torch.no_grad():
        bn.running_mean.fill_(5.0)
    y = run(bn, to_torch(x_seq)).numpy().reshape(-1, 12)
    np.testing.assert_allclose(y.mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.var(axis=0), 1.0, atol=1e-3)
    assert float(bn.running_mean.max()) < 5.0


def test_layernorm_eps_is_jax_default(x_seq):
    """eps 1e-6, not torch's 1e-5: visible on a near-constant row."""
    x = x_seq * 1e-3
    jmod = J.LayerNorm()
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    pmod = port_load(P.LayerNorm(12), W._ln, v)
    assert pmod.eps == 1e-6
    np.testing.assert_allclose(run(pmod, to_torch(x)).numpy(),
                               np.asarray(jmod.apply(v, x)), atol=1e-5)


def test_pools_and_leaky_relu(x_seq):
    from flax import linen as fnn
    xt = to_torch(x_seq)
    np.testing.assert_allclose(P.avg_pool1d(xt, 4).numpy(),
                               np.asarray(J.avg_pool1d(x_seq, 4)), atol=1e-6)
    np.testing.assert_allclose(P.max_pool1d(xt, 3).numpy(),
                               np.asarray(fnn.max_pool(x_seq, (3,), (3,),
                                                       "VALID")), atol=0)
    np.testing.assert_allclose(P.leaky_relu(xt).numpy(),
                               np.asarray(J.leaky_relu(x_seq)), atol=0)


def _mha_pair(e, h, output_scale, x):
    jmod = J.MultiheadAttention(e, h, output_scale=output_scale)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x, x, x))
    pmod = port_load(P.MultiheadAttention(e, h, output_scale=output_scale,
                                          generator=gen()), W._mha, v)
    return jmod, v, pmod


@pytest.mark.parametrize("n,output_scale", [(80, 1.0), (80, 2.0), (10, 1.0),
                                            (10, 2.0)],
                         ids=["flash", "flash-temp", "eager", "eager-temp"])
def test_mha_both_branches(n, output_scale, monkeypatch):
    """N >= 64 takes the fused-kernel branch (JAX: Pallas in interpret
    mode), N = 10 the eager branch; the temperature divides the output."""
    x = np.random.default_rng(2).standard_normal((2, n, 24)).astype(
        np.float32)
    jmod, v, pmod = _mha_pair(24, 4, output_scale, x)
    want = np.asarray(jmod.apply(v, x, x, x, deterministic=True))
    calls = []
    real = P.flash_attention
    monkeypatch.setattr(P, "flash_attention",
                        lambda *a: calls.append(1) or real(*a))
    xt = to_torch(x)
    got = run(pmod, xt, xt, xt).numpy()
    assert len(calls) == (1 if n >= 64 else 0)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("nq,nk", [(5, 10), (70, 90)],
                         ids=["eager", "flash"])
def test_mha_kv_hoist(nq, nk):
    """A K/V projection hoisted out of a weight-shared stack gives the same
    result as projecting again, in both packages."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, nq, 24)).astype(np.float32)
    mem = rng.standard_normal((2, nk, 24)).astype(np.float32)
    jmod = J.MultiheadAttention(24, 4, output_scale=2.0)
    v = perturb(jmod.init(jax.random.PRNGKey(0), q, mem, mem))
    want, jkv = jmod.apply(v, q, mem, mem, return_kv=True)
    want2 = jmod.apply(v, q + 1.0, mem, mem, kv=jkv)
    pmod = port_load(P.MultiheadAttention(24, 4, output_scale=2.0,
                                          generator=gen()), W._mha, v)
    qt, mt = to_torch(q), to_torch(mem)
    got, kv = run(pmod, qt, mt, mt, return_kv=True)
    got2 = run(pmod, qt + 1.0, mt, mt, kv=kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), atol=2e-5)
    np.testing.assert_allclose(kv[0].numpy(),
                               np.asarray(jkv[0]).astype(np.float32),
                               atol=1e-5)


@pytest.mark.parametrize("conv_sizes", [(1, 3, 5), (1, 2, 3)])
def test_encoder_block(conv_sizes):
    """THAT's encoder layer (flash-gated attention at 70 tokens, the
    "SAME" conv bank, BN with non-trivial running stats)."""
    x = np.random.default_rng(4).standard_normal((2, 70, 30)).astype(
        np.float32)
    jmod = JEncoderBlock(30, 10, conv_sizes)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jmod.apply(v, x))
    pmod = port_load(EncoderBlock(30, 10, conv_sizes, generator=gen()),
                     lambda sd, p, s, pre: W._encoder_block(
                         sd, p, s, pre, len(conv_sizes)),
                     v, v["batch_stats"])
    np.testing.assert_allclose(run(pmod, to_torch(x)).numpy(), want,
                               atol=2e-5)


def test_gaussian_position():
    x = np.random.default_rng(5).standard_normal((2, 150, 27)).astype(
        np.float32)
    jmod = JGaussianPosition(27, 150)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jmod.apply(v, x))
    pmod = port_load(GaussianPosition(27, 150, generator=gen()),
                     W._gaussian, v)
    assert "var_position" not in pmod.state_dict()
    np.testing.assert_allclose(run(pmod, to_torch(x)).numpy(), want,
                               atol=1e-5)
