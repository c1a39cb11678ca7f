"""int8 serving of the port's WiMANS baselines against the JAX package's,
on the CPU, in f32, at test_torch_port_csi_baselines.py's sizes and
weights: MLP in w8 (its ``QUANT_DEFAULTS``) and CNN-1D in w8a8 (on
request), each quantized in both packages from the same float weights and
calibration windows.

- The hooked set and the quantization: MLP's layer_0 and layer_1 int8
  with their weight scales, its 54-wide head float (6,912 weights, under
  ``DEFAULT_MIN_WEIGHT_SIZE``); CNN-1D's three convs and its head int8
  with input scales; the int8 weights and weight scales equal, the input
  scales within 1e-5 relative.
- Layer by layer, each quantized layer of the port fed its own input in
  the quantized forward, and JAX's layer fed the same input with JAX's
  quantized leaves: the outputs within LAYER_TOL (1e-5) of their largest
  magnitude; for CNN-1D also the prologue's int8 codes (JAX's
  ``quantize_activation`` in the conv's column layout) and the int32
  product (JAX's int8 ``conv_general_dilated``) bit for bit.
- The logits of JAX's quantized tree carried across against JAX's,
  within 1e-2 (w8) and 2e-2 (w8a8) of the largest logit, as for DETR;
  the port's MLP w8 logits within JAX's own bound of the float ones (0.25
  of their spread, tests/test_quantize.py).
- ``CSIServer`` with ``quant="auto"`` serves MLP in w8 from (n, T, C)
  windows, calibrating on (n, T, C) windows as well (the model flattens
  them).
- CNN-2D in w8 and w8a8 (``test_cnn2d_int8_raises``, whose name is kept
  though nothing raises now): stages 1 and 2 int8 in both packages (stage
  0 never announces: JAX's raw parameters, the port's unhooked Conv2d),
  the quantization equal, the port's logits within MODEL_TOL of JAX's
  quantized tree's, and ``CSIServer`` serving the same logits; the 2-D
  columns are held bit for bit in test_torch_port_int8_conv3d.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu.nn import layers as J
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.core.serving import CSIServer
from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
from test_torch_port_csi_baselines import pair, windows
from test_torch_port_int8_fused import jax_conv, numpy_columns
from test_torch_port_quantize import LAYER_TOL, assert_same_quantization
from test_torch_port_layers import run, to_torch

torch.set_num_threads(1)

MODE = {"MLP": "w8", "CNN-1D": "w8a8"}
MODEL_TOL = {"w8": 1e-2, "w8a8": 2e-2}     # of the largest logit
MLP_FLOAT_BOUND = 0.25                     # of the float logits' spread
# port layer -> (JAX module name, JAX layer, conv geometry or None)
LAYERS = {
    "MLP": {"layer_0": ("layer_0", lambda: J.Linear(256), None),
            "layer_1": ("layer_1", lambda: J.Linear(128), None)},
    "CNN-1D": {
        "layer_cnn_1d_0": ("conv_0", lambda: J.Conv1d(128, 29, stride=13),
                           (29, 13)),
        "layer_cnn_1d_1": ("conv_1", lambda: J.Conv1d(256, 15, stride=7),
                           (15, 7)),
        "layer_cnn_1d_2": ("conv_2", lambda: J.Conv1d(512, 3), (3, 1)),
        "layer_linear": ("head", lambda: J.Linear(54), None)},
}


@pytest.fixture(scope="module", params=sorted(MODE))
def case(request):
    """(key, mode, JAX model, float variables, JAX's quantized variables,
    calibration windows)."""
    key = request.param
    jmodel, variables, _ = pair(key)
    x = windows(key, n=4, seed=8)
    qv = qz.quantize_for_serving(jmodel, variables, [x], mode=MODE[key],
                                 train=False)
    return key, MODE[key], jmodel, variables, qv, x


def port_quantized(key, mode, x):
    _, _, port = pair(key)
    return Q.quantize_for_serving(port, [to_torch(x)], mode=mode)


def test_quantization_matches_jax(case):
    key, mode, _, _, qv, x = case
    port = port_quantized(key, mode, x)
    sd = port.state_dict()
    assert_same_quantization(sd, W.state_dict_from_jax(key, qv))
    int8 = sorted(k[:-len(".weight")] for k, v in sd.items()
                  if v.dtype == torch.int8)
    assert int8 == sorted(LAYERS[key])
    scales = sorted(k[:-len(".input_scale")] for k in sd
                    if k.endswith("input_scale"))
    assert scales == (int8 if mode == "w8a8" else [])


def layer_inputs(port, x, names):
    """The input of each layer of ``names`` in the port's forward."""
    seen = {}
    hooks = [module.register_forward_pre_hook(
        lambda m, args, name=name: seen.setdefault(name, args[0]))
        for name, module in port.named_modules() if name in names]
    try:
        run(port, to_torch(x))
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_layers_match_jax(case):
    """Each quantized layer on its own input, against JAX's layer on the
    same input and leaves; CNN-1D's codes and int32 products bit for
    bit."""
    key, mode, _, _, qv, x = case
    port = port_quantized(key, mode, x)
    inputs = layer_inputs(port, x, LAYERS[key])
    assert sorted(inputs) == sorted(LAYERS[key])
    for name, (jname, make, conv) in LAYERS[key].items():
        xin = inputs[name]
        params = qv["params"][jname]
        want = np.asarray(make().apply({"params": params}, xin.numpy()))
        got = run(port.get_submodule(name), xin).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LAYER_TOL * np.abs(want).max(),
                                   err_msg=name)
        if conv is None or mode != "w8a8":
            continue
        k, stride = conv
        layer = port.get_submodule(name)
        scale = layer.input_scale
        codes = Q.quantize_columns(xin, scale, k, stride)
        xq = np.asarray(qz.quantize_activation(jnp.asarray(xin.numpy()),
                                               jnp.asarray(scale.numpy())))
        kg = xin.shape[-1] * k
        want_codes = numpy_columns(xq, k, stride, 1, (0, 0), 1)
        np.testing.assert_array_equal(codes[..., :kg].numpy(), want_codes,
                                      err_msg=name)
        kernel = jnp.asarray(params["conv"]["kernel"])
        want_sum = np.asarray(jax_conv(jnp.asarray(xq), kernel, stride, 1,
                                       (0, 0), 1, int32=True))
        n = layer.weight.shape[0]
        got_sum = K.int8_matmul(codes[:, 0], layer.weight_padded)
        np.testing.assert_array_equal(
            got_sum.reshape(want_sum.shape).numpy(), want_sum, err_msg=name)
        assert got_sum.shape[-1] == n


def test_logits_match_jax(case):
    key, mode, jmodel, variables, qv, x = case
    want = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False))(qv, x))
    _, _, carried = pair(key)
    Q.load_quantized(carried, W.state_dict_from_jax(key, qv))
    got = run(carried, to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MODEL_TOL[mode] * np.abs(want).max())
    _, _, float_port = pair(key)
    ref = run(float_port, to_torch(x)).numpy()
    mine = run(port_quantized(key, mode, x), to_torch(x)).numpy()
    spread = np.abs(mine - ref).max() / (ref.std() + 1e-9)
    print(f"{key} {mode}: {spread:.4f} of the float logits' spread")
    if key == "MLP":
        assert spread < MLP_FLOAT_BOUND


def test_mlp_auto_serves_w8_from_windows():
    """--quant auto is w8 for MLP: the server calibrates on (n, T, C)
    windows, which the model flattens, quantizes as JAX does, and answers
    (n, T, C) requests."""
    jmodel, variables, port = pair("MLP")
    x = windows("MLP", n=4, seed=8)
    qv = qz.quantize_for_serving(jmodel, variables, [x], mode="w8",
                                 train=False)
    calib = x.reshape(4, 60, 20)
    server = CSIServer("MLP", port, dtype="float32", device="cpu", batch=3,
                       quant="auto", calib=calib)
    assert server.quant == "w8"
    assert_same_quantization(server.model.state_dict(),
                             W.state_dict_from_jax("MLP", qv))
    got = server(calib).numpy()
    want = run(port_quantized("MLP", "w8", x), to_torch(x)).numpy()
    assert got.shape == (4, 54)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_cnn2d_int8_raises(mode):
    """CNN-2D's int8 serving in ``mode`` against JAX's (see the module
    docstring)."""
    key = "CNN-2D"
    jmodel, variables, port = pair(key)
    x = windows(key, n=2)
    qv = qz.quantize_for_serving(jmodel, variables, [x], mode=mode,
                                 train=False)
    Q.quantize_for_serving(port, [to_torch(x)], mode=mode)
    sd = port.state_dict()
    assert_same_quantization(sd, W.state_dict_from_jax(key, qv))
    assert sorted(k for k, v in sd.items() if v.dtype == torch.int8) == [
        "layer_cnn_2d_1.weight", "layer_cnn_2d_2.weight"]
    assert (sorted(k for k in sd if k.endswith("input_scale"))
            == (["layer_cnn_2d_1.input_scale", "layer_cnn_2d_2.input_scale"]
                if mode == "w8a8" else []))
    want = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False))(qv, x))
    got = run(port, to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MODEL_TOL[mode] * np.abs(want).max())
    server = CSIServer(key, pair(key)[2], dtype="float32", device="cpu",
                       batch=2, quant=mode, calib=x)
    np.testing.assert_allclose(server(x).numpy(), got, rtol=1e-6, atol=1e-6)
