"""The port's int8 serving (core/quantize.py, the int8 paths of
nn/layers.py, core/serving.py) against the JAX package's core/quantize.py
on the CPU, in f32, on the same weights and numpy inputs.

- The quantizers are bit for bit JAX's: per-channel weights (int8 and
  scales), per-tensor activations with round-half-to-even at exact ties,
  and the 99.9th percentile of calibration.
- Float weights carried across and quantized in each package give the
  same hooked set (mapped onto the port's names by
  ``state_dict_from_jax``), equal int8 weights and weight scales, and
  input scales within 1e-5 relative (the two packages compute the
  calibration activations in f32 in another order).
- A tree quantized in JAX, carried across, gives JAX's outputs: to 1e-5
  of the output's largest magnitude (the attention to 2e-3, see MHA_TOL).
- MViT hooks its Linears only, as in JAX; its Conv3d stay float.

DETR and THAT_ENCODER: tests/test_torch_port_quantize_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import config as jax_config
from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu.models.video import mvit as jax_mvit
from multi_modal_csi_tpu.nn import layers as J
from multi_modal_csi_tpu_torch.core import config as port_config
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.core.serving import CSIServer
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.runners.csi import build_model
from multi_modal_csi_tpu_torch.runners.video import build_video_model
from test_torch_port_layers import gen, perturb, port_load, run, to_torch

torch.set_num_threads(1)

MODES = ("w8", "w8a8")
LAYER_TOL = 1e-5          # of the layer output's largest magnitude
# the attention's output projection takes its context in bf16, and a
# context value that the two packages' f32 attention put on either side of
# a bf16 rounding boundary moves the output by one bf16 step (2^-8) of
# that value times a weight: with contexts up to about 1 and weights up to
# 0.11 (xavier at 128 wide) one such flip is up to 4e-4, about 1.6e-3 of
# the largest output (measured: 2.2e-4 at most)
MHA_TOL = 2e-3
SCALE_RTOL = 1e-5         # calibrated input scales, two f32 forwards
SCALE_SUFFIXES = ("weight_scale", "input_scale")


def rng_array(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def quantized_entries(sd):
    """The int8 weights and scale buffers of a port state dict."""
    return {k: v for k, v in sd.items()
            if v.dtype == torch.int8 or k.endswith(SCALE_SUFFIXES)}


def assert_same_quantization(port_sd, jax_sd):
    """Same names; int8 weights and weight scales equal; input scales
    within SCALE_RTOL."""
    a, b = quantized_entries(port_sd), quantized_entries(jax_sd)
    assert sorted(a) == sorted(b)
    for k in a:
        if k.endswith("input_scale"):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                       rtol=SCALE_RTOL, err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------- #
# the quantizers
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("shape", [(96, 64), (5, 12, 7), (270, 810)],
                         ids=["linear", "conv", "in-proj"])
def test_quantize_array_bit_for_bit(shape):
    """JAX's kernel layout keeps the output channel last, the port's
    first; a hot channel and an all-zero one included. JAX quantizes its
    tree under jit (``quantize_params``), as compared here."""
    w = rng_array(shape, 1)
    w[..., 3] *= 100.0
    w[..., 4] = 0.0
    jq, js = jax.jit(qz.quantize_array)(jnp.asarray(w))
    port_w = torch.from_numpy(np.moveaxis(w, -1, 0).copy())
    q, s = Q.quantize_array(port_w)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.moveaxis(np.asarray(jq),
                                                         -1, 0))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_activation_bit_for_bit_at_ties():
    scale = np.float32(0.05)
    x = rng_array((64, 130), 2, 3.0)
    x[0, :20] = (np.arange(-10, 10) + 0.5).astype(np.float32) * scale
    x[1, :4] = [1e6, -1e6, 127.5 * scale, -127.5 * scale]
    want = np.asarray(qz.quantize_activation(jnp.asarray(x), scale))
    got = Q.quantize_activation(torch.from_numpy(x), torch.tensor(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 999, 4096, 100003])
def test_p999_matches_jnp_quantile(n):
    x = rng_array((n,), 3)
    want = float(jnp.quantile(jnp.abs(jnp.asarray(x)), 0.999))
    got = float(Q.p999(torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-6)


def test_resolve_quant_matches_jax():
    """The cases of tests/test_quantize.py:210-221, and the table."""
    assert port_config.QUANT_DEFAULTS == jax_config.QUANT_DEFAULTS
    for quant, model in [("auto", "DETR"), ("auto", "MLP"),
                         ("auto", "CNN-2D"), ("auto", "THAT"),
                         ("auto", "ResNet"), ("auto", "Swin-T"),
                         ("auto", "THAT_ENCODER"), ("none", "DETR"),
                         (None, "DETR"), ("w8", "CNN-2D"),
                         ("w8a8", "THAT")]:
        assert (port_config.resolve_quant(quant, model)
                == jax_config.resolve_quant(quant, model))
    with pytest.raises(ValueError):
        port_config.resolve_quant("int4", "DETR")


# ---------------------------------------------------------------------- #
# layers: quantized in each package, and JAX's quantization carried over
# ---------------------------------------------------------------------- #

def _quantize_jax_layer(jmod, v, x, mode, stat="amax"):
    return qz.quantize_for_serving(jmod, v, [x], mode=mode, min_size=1,
                                   stat=stat)


def _carry(fill, qparams, pmod_fn):
    """A port layer holding JAX's quantized leaves."""
    holder = {}
    fill(holder, qparams, "m")
    module = torch.nn.ModuleDict({"m": pmod_fn()})
    Q.load_quantized(module, holder)
    return module["m"].eval(), {k[2:]: t for k, t in holder.items()}


@pytest.mark.parametrize("mode", MODES)
def test_linear_matches_jax(mode):
    x = rng_array((4, 7, 96), 4)
    jmod = J.Linear(64)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    qv = _quantize_jax_layer(jmod, v, x, mode)
    want = np.asarray(jmod.apply(qv, x))
    pmod = port_load(P.Linear(96, 64, generator=gen()), W._linear, v)
    Q.quantize_for_serving(pmod, [to_torch(x)], mode=mode, min_size=1)
    carried, jax_sd = _carry(W._linear, qv["params"],
                             lambda: P.Linear(96, 64, generator=gen()))
    assert_same_quantization(pmod.state_dict(), jax_sd)
    assert ("input_scale" in jax_sd) == (mode == "w8a8")
    for port in (pmod, carried):
        np.testing.assert_allclose(run(port, to_torch(x)).numpy(), want,
                                   rtol=0, atol=LAYER_TOL * np.abs(want).max())


CONVS = {
    "same": dict(kernel_size=3, padding="SAME"),
    "same-k2": dict(kernel_size=2, padding="SAME"),
    "dilated": dict(kernel_size=3, padding=4, dilation=4),
    "strided": dict(kernel_size=8, stride=8),
    "grouped": dict(kernel_size=3, padding=1, groups=4),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv1d_matches_jax(name, mode):
    kw = CONVS[name]
    x = rng_array((2, 40, 16), 5)
    jmod = J.Conv1d(features=12, kernel_size=kw["kernel_size"],
                    stride=kw.get("stride", 1),
                    padding=kw.get("padding", "VALID"),
                    dilation=kw.get("dilation", 1),
                    feature_group_count=kw.get("groups", 1), xavier=False)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    qv = _quantize_jax_layer(jmod, v, x, mode)
    want = np.asarray(jmod.apply(qv, x))

    def fresh():
        return P.Conv1d(16, 12, generator=gen(), xavier=False, **kw)

    pmod = port_load(fresh(), W._conv1d, v)
    Q.quantize_for_serving(pmod, [to_torch(x)], mode=mode, min_size=1)
    carried, jax_sd = _carry(W._conv1d, qv["params"], fresh)
    assert_same_quantization(pmod.state_dict(), jax_sd)
    for port in (pmod, carried):
        got = run(port, to_torch(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LAYER_TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [16, 80], ids=["eager", "flash"])
def test_mha_weight_only_matches_jax(n, mode):
    """A 128-wide MHA (4 heads): in_proj_weight and out_proj.weight are
    weight-only (scales, never an input_scale) under both modes; the
    attention's serving dtype follows the bias."""
    x = rng_array((2, n, 128), 6)

    class SelfAttn(J.nn.Module):
        @J.nn.compact
        def __call__(self, x):
            return J.MultiheadAttention(128, 4, name="attn")(
                x, x, x, deterministic=True)

    jmod = SelfAttn()
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    qv = qz.quantize_for_serving(jmod, v, [x], mode=mode, min_size=4096)
    want = np.asarray(jmod.apply(qv, x))

    def fresh():
        return P.MultiheadAttention(128, 4, generator=gen())

    pmod = port_load(fresh(), W._mha, {"params": v["params"]["attn"]})
    stats = Q.calibrate(_SelfAttn(pmod), [to_torch(x)])
    assert stats == {"m.in_proj_weight": None, "m.out_proj.weight": None}
    Q.quantize_model(_SelfAttn(pmod), stats, mode=mode, min_size=4096)
    carried, jax_sd = _carry(W._mha, qv["params"]["attn"], fresh)
    assert_same_quantization(pmod.state_dict(), jax_sd)
    assert sorted(quantized_entries(jax_sd)) == [
        "in_proj_weight", "in_proj_weight_scale", "out_proj.weight",
        "out_proj.weight_scale"]
    xt = to_torch(x)
    for port in (pmod, carried):
        np.testing.assert_allclose(run(port, xt, xt, xt).numpy(), want,
                                   rtol=0, atol=MHA_TOL * np.abs(want).max())


class _SelfAttn(torch.nn.Module):
    def __init__(self, mha):
        super().__init__()
        self.m = mha

    def forward(self, x):
        return self.m(x, x, x)


@pytest.mark.parametrize("stat", ["amax", "p999"])
def test_calibration_stat_matches_jax(stat):
    """With one spike in the calibration data, amax stretches the scale
    and p999 does not (tests/test_quantize.py:303-325); each scale is
    JAX's."""
    x = rng_array((64, 128), 7)
    x[0, 0] = 1000.0
    jmod = J.Linear(64)
    v = perturb(jmod.init(jax.random.PRNGKey(0), x))
    qv = _quantize_jax_layer(jmod, v, x, "w8a8", stat)
    want = float(qv["params"]["input_scale"])
    pmod = port_load(P.Linear(128, 64, generator=gen()), W._linear, v)
    Q.quantize_for_serving(pmod, [to_torch(x)], mode="w8a8", min_size=1,
                           stat=stat)
    got = float(pmod.input_scale)
    assert got == pytest.approx(want, rel=1e-6)
    assert (got > 1000 / 127 * 0.99) == (stat == "amax")


# ---------------------------------------------------------------------- #
# MViT: only its Linears are hooked
# ---------------------------------------------------------------------- #

def jax_hooked(jmodel, variables, x, **apply_kw):
    """JAX calibrate's hooked set, keyed and valued by its rules
    (``qz.calibrate``: a sown input statistic names the layer's kernel, a
    weight-only mark names its param, with None), read from the traced
    ``quant_stats`` tree, so nothing is compiled. Values are 1.0."""
    tree = jax.eval_shape(lambda v, b: jmodel.apply(
        v, b, mutable=[qz.STATS_COL], **apply_kw)[1], variables, x)
    stats = {}
    for keypath, _ in jax.tree_util.tree_flatten_with_path(
            tree.get(qz.STATS_COL, {}))[0]:
        names = qz._dict_path(keypath)
        if names[-1].startswith("wonly__"):
            stats.setdefault(names[:-1] + (names[-1][len("wonly__"):],),
                             None)
        elif names[-1] == "amax":
            stats[names[:-1] + ("kernel",)] = 1.0
    return stats


def test_mvit_hooks_only_linears_as_jax_does():
    """The hooked set of MViT-v2, quantized at min_size 1 in both packages
    and mapped onto the port's names: the Linears only; every Conv3d stays
    float."""
    key, clip = "MViT-v2", (4, 32, 32)
    x = rng_array((1, *clip, 3), 9)
    jmodel = jax_mvit.MViT(6, variant="v2")
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(1)}, b, train=False), x)
    variables = jax.tree_util.tree_map(
        lambda t: np.zeros(t.shape, t.dtype), shapes)
    hooked = jax_hooked(jmodel, variables, x, train=False)
    qv = qz.quantize_params(variables["params"], hooked, mode="w8",
                            min_size=1)
    jax_names = sorted(quantized_entries(
        W.state_dict_from_jax(key, {"params": qv})))
    port = build_video_model(key, 6, clip).eval()
    Q.quantize_for_serving(port, [to_torch(x)], mode="w8", min_size=1)
    assert sorted(quantized_entries(port.state_dict())) == jax_names
    int8 = [name for name, m in port.named_modules()
            if getattr(getattr(m, "weight", None), "dtype", None)
            == torch.int8]
    assert int8 and all(isinstance(port.get_submodule(n), P.Linear)
                        for n in int8)
    assert all(m.weight.dtype == torch.float32 for m in port.modules()
               if isinstance(m, P.Conv3d))


def test_server_refuses_w8a8_without_calibration():
    with pytest.raises(ValueError, match="calib"):
        CSIServer("DETR", build_model("DETR", seed=0), device="cpu",
                  quant="w8a8")
    with pytest.raises(ValueError, match="calib"):
        CSIServer("THAT_ENCODER", build_model("THAT_ENCODER", seed=0),
                  device="cpu", quant="auto")
