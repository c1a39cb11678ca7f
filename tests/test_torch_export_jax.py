"""The port's CPU serving artifacts against the JAX package's CPU artifacts
(``core/export.py::load_serving`` of each), on the same weights carried
across with ``core/weights.py``, and the input-BatchNorm folds against
JAX's ``fold_input_norm``.

Tolerances, of the largest logit: f32 within 1e-4; bf16 within 0.02 of
the largest f32 logit (the bound of tests/test_torch_port_serving.py,
where the two packages round bf16 at other places); w8 and w8a8 within
``MODEL_TOL`` of tests/test_torch_port_quantize_models.py (1e-2 and 2e-2:
activations that the two packages' f32 arithmetic puts on either side of
a rounding boundary take the other code, and that compounds over the
quantized layers). A folded model equals the unfolded eval forward within
1e-5 of its largest logit, and the port's folded weights are JAX's within
1e-6 relative (both fold in float64 and round once to f32).

THAT_ENCODER's w8a8 artifact is held in
tests/test_torch_export_jax_encoder.py. Sizes: DETR with 2 decoder layers
on (2, 600, 270) windows, as the JAX package's export test sizes it; MLP on 60 x 20 windows (JAX's
tests/test_csi_models.py), CNN-2D on 251 x 251. The bf16 bound was set
where each package's own bf16 logits are about 2% off its f32 ones; on
these windows DETR's are 1.0% off in both and the packages 0.75% apart
(measured). On (2, 300, 270) windows each package's own bf16 is 2.9-3.0%
off its f32 and the packages 2.2% apart, past the bound, so 300 is not
used here; their f32 artifacts agree within 7.3e-7 of the largest logit
at both lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import export as JE
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.models import csi as JM
from multi_modal_csi_tpu.models.csi import cnn_2d as jax_cnn_2d
from multi_modal_csi_tpu.models.csi import mlp as jax_mlp
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.core.export import (export_serving,
                                                   load_serving)
from multi_modal_csi_tpu_torch.models.csi import cnn_2d, mlp
from multi_modal_csi_tpu_torch.models.csi.detr import DETRMultiUser
from test_torch_port_csi_baselines import pair, windows
from test_torch_port_layers import gen, perturb
from test_torch_port_quantize_models import MODEL_TOL

torch.set_num_threads(1)

LAYERS = 2
F32_SHARE = 1e-4
BF16_SHARE = 2e-2
FOLD_SHARE = 1e-5


def _jax_artifact(jmodel, variables, x, **kw):
    """JAX's CPU artifact of ``jmodel`` on ``variables``, called on x."""
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    blob = JE.export_serving(jmodel, v, x, platforms=("cpu",), **kw)
    return np.asarray(JE.load_serving(blob)(jnp.asarray(x)))


def _port_artifact(model, x, fed=None, **kw):
    blob = export_serving(model, x, platforms=("cpu",), **kw)
    return load_serving(blob, "cpu")(x if fed is None else fed).numpy()


def _carried(key, jmodel, port, x):
    """Perturbed JAX variables from the port model's weights, and the port
    model loaded with them."""
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), x[:1])
    variables = perturb(import_state_dict(key, port.state_dict(), shapes))
    port.load_state_dict(W.state_dict_from_jax(
        key, variables, num_decoder_layers=LAYERS), strict=True)
    return variables, port.eval()


@pytest.fixture(scope="module")
def detr():
    x = np.random.default_rng(8).normal(size=(2, 600, 270)).astype(
        np.float32)
    jmodel = JM.DETRMultiUser(num_decoder_layers=LAYERS)
    variables, port = _carried("DETR", jmodel, DETRMultiUser(
        num_decoder_layers=LAYERS, length=600, generator=gen()), x)
    return jmodel, variables, port, x, _jax_artifact(jmodel, variables, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detr_artifact_matches_jax(detr, dtype):
    jmodel, variables, port, x, f32 = detr
    want = (f32 if dtype == "float32" else
            _jax_artifact(jmodel, variables, x, serving_dtype=dtype))
    got = _port_artifact(port, x, serving_dtype=dtype)
    assert got.shape == want.shape == (LAYERS, 2, 5, 10)
    share = F32_SHARE if dtype == "float32" else BF16_SHARE
    assert np.abs(got - want).max() <= share * np.abs(f32).max()


def test_mlp_w8_folded_int8_input_artifact_matches_jax():
    """MLP served as the JAX CLI serves it by default with w8 and an int8
    input: the input BatchNorm folded into layer_0, both hidden layers
    int8, the host's int8 windows dequantized in the program."""
    jmodel, variables, port = pair("MLP")
    x = windows("MLP", n=4)
    scale = float(np.abs(x).max()) / 127.0
    x8 = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    folded = jax_mlp.fold_input_norm(jax.tree_util.tree_map(jnp.asarray,
                                                            variables))
    want = _jax_artifact(jax_mlp.MLP(out_features=54, fold_input_norm=True),
                         folded, x8, quant="w8", input_dtype="int8",
                         input_scale=scale)
    model = mlp.MLP(54, in_features=x.shape[1], fold_input_norm=True,
                    generator=gen())
    model.load_state_dict(mlp.fold_input_norm(port.state_dict()))
    got = _port_artifact(model.eval(), x8, quant="w8", input_dtype="int8",
                         input_scale=scale)
    assert got.shape == want.shape == (4, 54)
    assert np.abs(got - want).max() <= MODEL_TOL["w8"] * np.abs(want).max()


@pytest.mark.parametrize("key", ["MLP", "CNN-2D"])
def test_fold_matches_jax(key):
    jmodel, variables, port = pair(key)
    module = mlp if key == "MLP" else cnn_2d
    jax_module = jax_mlp if key == "MLP" else jax_cnn_2d
    sd = module.fold_input_norm(port.state_dict())
    want = W.state_dict_from_jax(key, jax_module.fold_input_norm(
        jax.tree_util.tree_map(jnp.asarray, variables)))
    assert set(sd) == set(want)
    for name in sd:
        np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    if key == "MLP":
        folded = mlp.MLP(54, in_features=1200, fold_input_norm=True,
                         generator=gen())
    else:
        folded = cnn_2d.CNN2D(54, fold_input_norm=True, generator=gen())
    folded.load_state_dict(sd, strict=True)
    x = torch.from_numpy(windows(key))
    with torch.no_grad():
        ref, got = port(x), folded.eval()(x)
    assert (got - ref).abs().max() <= FOLD_SHARE * ref.abs().max()
