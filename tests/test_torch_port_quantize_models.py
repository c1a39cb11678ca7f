"""The port's int8 serving of DETR (2 decoder layers) and THAT_ENCODER
(2 decoder layers, temperature 2) against the JAX package's, on the CPU, in
f32, on the same weights and (2, 600, 270) windows, as the JAX package's
own tests size them (tests/test_quantize.py:156-171, :285-300).

- Quantized in each package from the same float weights: the same hooked
  set mapped onto the port's names (at min_size 1, every announcement
  shows), equal int8 weights and weight scales, input scales within 1e-5
  relative; at the default min_size the class heads and DETR's depthwise
  conv stay float, and no attention projection carries an input scale.
- JAX's quantized tree, carried across, against JAX's logits: within 1e-2
  (w8) and 2e-2 (w8a8) of the largest logit. The float models agree to
  7e-7; each quantized layer rounds its input (to bf16 under w8, to the
  int8 grid under w8a8), and an activation that the two packages' f32
  arithmetic puts on either side of a rounding boundary takes the other
  value in one of them. A few such flips among DETR's 324,000 pointwise
  inputs move that layer's output by 2e-4 (w8) and 1.1e-3 (w8a8) of its
  largest value, and they compound over the quantized layers to 3.4e-3
  and 8.8e-3 of the largest logit (DETR; THAT_ENCODER 1.5e-3 and
  7.4e-3), measured.
- The port's own quantization stays within JAX's own bound of the float
  model: 0.35 (DETR) and 0.5 (THAT_ENCODER) of the logits' spread.
"""

import jax
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.models import csi as M
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.models.csi import THATEncoderDETR
from multi_modal_csi_tpu_torch.models.csi.detr import DETRMultiUser
from test_torch_port_layers import gen, perturb, run, to_torch
from test_torch_port_quantize import (MODES, assert_same_quantization,
                                      rng_array)

torch.set_num_threads(1)

LENGTH, LAYERS = 600, 2
MODEL_TOL = {"w8": 1e-2, "w8a8": 2e-2}    # of the largest logit
FLOAT_BOUND = {"DETR": 0.35, "THAT_ENCODER": 0.5}


def _models(key):
    if key == "DETR":
        return (M.DETRMultiUser(num_decoder_layers=LAYERS),
                DETRMultiUser(num_decoder_layers=LAYERS, length=LENGTH,
                              generator=gen()))
    return (M.THATEncoderDETR(temp_cross=2.0, num_queries=5,
                              num_decoder_layers=LAYERS),
            THATEncoderDETR(temp_cross=2.0, num_decoder_layers=LAYERS,
                            length=LENGTH, generator=gen()))


def _port(key, variables, quantized=False):
    _, port = _models(key)
    sd = W.state_dict_from_jax(key, variables, num_decoder_layers=LAYERS)
    if quantized:
        Q.load_quantized(port, sd)
    else:
        port.load_state_dict(sd, strict=True)
    return port.eval()


@pytest.fixture(scope="module", params=["DETR", "THAT_ENCODER"])
def model_case(request):
    """(key, JAX model, perturbed float variables, windows, JAX's
    calibration of them, jitted JAX forward)."""
    key = request.param
    x = rng_array((2, LENGTH, 270), 8)
    jmodel, port = _models(key)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False), x)
    variables = perturb(import_state_dict(key, port.state_dict(), shapes))
    stats = qz.calibrate(lambda v, b, mutable: jmodel.apply(
        v, b, train=False, mutable=mutable), variables, [x])
    apply = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))
    return key, variables, x, stats, apply


def _jax_quantized(variables, stats, mode, min_size=Q.DEFAULT_MIN_WEIGHT_SIZE):
    return {**variables, "params": qz.quantize_params(
        variables["params"], stats, mode=mode, min_size=min_size)}


@pytest.mark.parametrize("mode", MODES)
def test_model_quantization_matches_jax(model_case, mode):
    key, variables, x, stats, _ = model_case
    for min_size in (1, Q.DEFAULT_MIN_WEIGHT_SIZE):
        qv = _jax_quantized(variables, stats, mode, min_size)
        jax_sd = W.state_dict_from_jax(key, qv, num_decoder_layers=LAYERS)
        port = _port(key, variables)
        Q.quantize_for_serving(port, [to_torch(x)], mode=mode,
                               min_size=min_size)
        assert_same_quantization(port.state_dict(), jax_sd)
    sd = port.state_dict()
    assert not any("class_embed" in k and sd[k].dtype == torch.int8
                   for k in sd)
    assert not any(k.endswith(("out_proj.input_scale", "attn.input_scale",
                               "attention.input_scale")) for k in sd)
    if key == "DETR":
        assert sd["feature_extractor.initial_conv.depthwise.weight"].dtype \
            == torch.float32
        assert sd["feature_extractor.final_conv.weight"].dtype == torch.int8


@pytest.mark.parametrize("mode", MODES)
def test_model_logits_match_jax(model_case, mode):
    key, variables, x, stats, apply = model_case
    qv = _jax_quantized(variables, stats, mode)
    want = np.asarray(apply(qv, x))
    got = run(_port(key, qv, quantized=True), to_torch(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MODEL_TOL[mode] * np.abs(want).max())
    ref = run(_port(key, variables), to_torch(x)).numpy()
    own = _port(key, variables)
    Q.quantize_for_serving(own, [to_torch(x)], mode=mode)
    mine = run(own, to_torch(x)).numpy()
    assert np.abs(mine - ref).max() / (ref.std() + 1e-9) < FLOAT_BOUND[key]
