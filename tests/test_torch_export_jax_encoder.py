"""THAT_ENCODER's w8a8 serving artifact of the port against the JAX
package's (``core/export.py::load_serving`` of each) on the CPU, on the
same weights carried across with ``core/weights.py`` and the same
calibration windows: within ``MODEL_TOL["w8a8"]`` (2e-2) of the largest
logit, the bound of tests/test_torch_port_quantize_models.py (tests/
test_torch_export_jax.py says why). THAT_ENCODER with 2 decoder layers and
temperature 2 on (2, 600, 270) windows, as the JAX package's quantization
tests size it.
"""

import numpy as np
import torch

from multi_modal_csi_tpu.models import csi as JM
from multi_modal_csi_tpu_torch.models.csi import THATEncoderDETR
from test_torch_export_jax import (LAYERS, _carried, _jax_artifact,
                                   _port_artifact)
from test_torch_port_layers import gen
from test_torch_port_quantize_models import MODEL_TOL

torch.set_num_threads(1)


def test_that_encoder_w8a8_artifact_matches_jax():
    x = np.random.default_rng(9).normal(size=(2, 600, 270)).astype(
        np.float32)
    jmodel = JM.THATEncoderDETR(temp_cross=2.0, num_queries=5,
                                num_decoder_layers=LAYERS)
    variables, port = _carried("THAT_ENCODER", jmodel, THATEncoderDETR(
        temp_cross=2.0, num_decoder_layers=LAYERS, length=600,
        generator=gen()), x)
    want = _jax_artifact(jmodel, variables, x, quant="w8a8", calib_x=[x])
    got = _port_artifact(port, x, quant="w8a8", calib_x=[x])
    assert got.shape == want.shape == (LAYERS + 1, 2, 5, 10)
    assert np.abs(got - want).max() <= (MODEL_TOL["w8a8"]
                                        * np.abs(want).max())
