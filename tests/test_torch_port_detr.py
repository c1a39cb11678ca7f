"""The port's DETR at the flagship configuration (token_length 10, 6
weight-shared decoder layers, temperature 2.0, 5 queries, FFN 512) against
the JAX package's, on the CPU, in f32, at full width: (2, 3000, 270)
windows from a numpy seed. Logits agree within 1e-4 absolute and relative.

DETR attends over 10 memory tokens and 5 queries, below the flash gate, so
neither package runs the attention kernel for it.
"""

import numpy as np
import torch

from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.runners.csi import build_model
from test_torch_port_layers import run, to_torch
from test_torch_port_that import (assert_same_tree, count_flash_calls,
                                  jax_forward, jax_model_and_variables,
                                  windows)

torch.set_num_threads(1)


def test_detr_matches_jax_at_full_width(monkeypatch):
    x = windows()
    port = build_model("DETR", seed=0)
    jmodel, variables = jax_model_and_variables("DETR", port)
    want = jax_forward(jmodel, variables, x)
    port.load_state_dict(state_dict_from_jax("DETR", variables), strict=True)
    calls = count_flash_calls(monkeypatch)
    got = run(port, to_torch(x)).numpy()
    assert got.shape == want.shape == (6, 2, 5, 10)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert calls == []


def test_detr_decoder_is_one_shared_layer():
    """One layer object under every decoder_layers index: the state dict
    repeats its tensors, and loading fills them all at once."""
    port = build_model("DETR", seed=0)
    layers = port.decoder.decoder_layers
    assert len(layers) == 6 and all(layer is layers[0] for layer in layers)
    sd = port.state_dict()
    name = "decoder.decoder_layers.{}.cross_attn.out_proj.weight"
    assert all(name.format(i) in sd for i in range(6))
    _, variables = jax_model_and_variables("DETR", port)
    port.load_state_dict(state_dict_from_jax("DETR", variables), strict=True)
    want = variables["params"]["decoder"]["shared_layer"]["cross_attn"][
        "out_proj_weight"].T
    np.testing.assert_array_equal(
        layers[5].cross_attn.out_proj.weight.detach().numpy(), want)
    assert "feature_extractor.dilated_blocks.2.bn.running_var" in sd


def test_detr_weights_round_trip_exactly():
    port = build_model("DETR", seed=0)
    _, variables = jax_model_and_variables("DETR", port)
    port.load_state_dict(state_dict_from_jax("DETR", variables), strict=True)
    back = import_state_dict("DETR", port.state_dict(), variables)
    assert_same_tree(back, variables)
