"""The port's THAT family at full width against the JAX package's, on the
CPU, in f32.

Windows are (2, 3000, 270) standard normals from a numpy seed. The JAX
variables start from the port's seeded initialisation (read into the JAX
tree by the JAX package's own importer) and are then perturbed with numpy
so that no leaf keeps its initial value; JAX applies them with its flash
attention in interpret mode, and the port loads them with
``load_state_dict(state_dict_from_jax(...), strict=True)``. Logits agree
within 1e-4 absolute and relative (f32 sums over 270-wide features and a
3000-step window, taken in another order).

The helpers here are shared with the DETR and serving tests.
"""

import jax
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.runners.csi import CSI_MODELS as JAX_MODELS
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.runners.csi import build_model, infer_out_dim
from test_torch_port_layers import perturb, run, to_torch

torch.set_num_threads(1)

THAT_KEYS = ["THAT", "THAT_MULTI_HEAD", "THAT_COUNT",
             "THAT_COUNT_CONSTRAINED"]


def windows(n=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3000, 270), dtype=np.float32)


def jax_model_and_variables(key, port_model, seed=1):
    """The JAX model for ``key`` and perturbed variables for it, in numpy."""
    jmodel = JAX_MODELS[key].build((3000, 270), infer_out_dim(key, "activity"),
                                   JaxConfig())
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                              train=False),
        jax.ShapeDtypeStruct((1, 3000, 270), np.float32))
    return jmodel, perturb(import_state_dict(key, port_model.state_dict(),
                                             shapes), seed)


def jax_forward(jmodel, variables, x):
    return np.asarray(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(variables, x))


def count_flash_calls(monkeypatch):
    """Record the attention kernel wrapper's calls from the attention
    layer (on the CPU it runs its plain version)."""
    calls = []
    real = P.flash_attention
    monkeypatch.setattr(P, "flash_attention",
                        lambda q, k, v: calls.append(
                            (tuple(q.shape), tuple(k.shape))) or real(q, k, v))
    return calls


def assert_same_tree(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_same_tree(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("key", THAT_KEYS)
def test_that_family_matches_jax_at_full_width(key, monkeypatch):
    x = windows()
    port = build_model(key, seed=0)
    jmodel, variables = jax_model_and_variables(key, port)
    want = jax_forward(jmodel, variables, x)
    port.load_state_dict(state_dict_from_jax(key, variables), strict=True)
    calls = count_flash_calls(monkeypatch)
    got = run(port, to_torch(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # four left-stream and one right-stream attention per forward
    assert calls == [((2, 150, 10, 27), (2, 150, 10, 27))] * 4 + [
        ((2, 270, 10, 15), (2, 270, 10, 15))]


def test_that_weights_round_trip_exactly():
    """JAX variables -> port state dict -> the JAX package's importer gives
    back the same variables, bit for bit."""
    port = build_model("THAT", seed=0)
    _, variables = jax_model_and_variables("THAT", port)
    port.load_state_dict(state_dict_from_jax("THAT", variables), strict=True)
    back = import_state_dict("THAT", port.state_dict(), variables)
    assert_same_tree(back, variables)


def test_that_parameter_names_follow_reference_layout():
    sd = build_model("THAT_MULTI_HEAD", seed=0).state_dict()
    for name in ("layer_left_encoder.0.layer_attention.in_proj_weight",
                 "layer_left_encoder.3.layer_cnn.2.1.running_var",
                 "layer_right_encoder.0.layer_cnn.1.0.weight",
                 "layer_left_gaussian.var_sigma", "layer_output.4.bias"):
        assert name in sd
    assert not any(k.endswith(("var_position", "num_batches_tracked"))
                   for k in sd)
