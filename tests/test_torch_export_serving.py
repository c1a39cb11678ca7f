"""DETR's serving artifacts (core/export.py) against the port's eager
server on the CPU, and the ragged shim around DETR's (L, B, Q, C) logits
(the JAX package's tests/test_export.py:249-286).

DETR with 2 decoder layers on (2, 300, 270) windows: the shortest windows
its CNN tokenizer takes (10 tokens). An artifact equals the eager server
(``CSIServer``) on the same weights, calibration and windows within 1e-6
of the largest logit (one traced program against the same Python code).
A ("cuda", "cpu") w8a8 artifact traced here holds the prologue and P1 as
``mmcsi`` ops, whose CPU implementations (the plain versions) it runs
here, and equals the eager server within the same 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch.core.export import (export_serving,
                                                   load_serving, serve_ragged)
from multi_modal_csi_tpu_torch.core.serving import CSIServer
from multi_modal_csi_tpu_torch.models.csi.detr import DETRMultiUser
from test_torch_export import assert_same, forward, gen, graph_ops

torch.set_num_threads(1)

LENGTH = 300


@pytest.fixture(scope="module")
def detr():
    """DETR, its float artifact for the CPU, and seeded windows."""
    model = DETRMultiUser(num_decoder_layers=2, length=LENGTH,
                          generator=gen()).eval()
    x = np.random.default_rng(4).normal(size=(2, LENGTH, 270)).astype(
        np.float32)
    fn = load_serving(export_serving(model, x, platforms=("cpu",)), "cpu")
    return model, x, fn


def test_serve_ragged_needs_the_batch_axis(detr):
    """L == B == 2 makes DETR's batch axis ambiguous: refused unless
    ``axis`` is given; then 5 windows in 3 batches equal the forward."""
    model, _, fn = detr
    big = np.random.default_rng(5).normal(size=(5, LENGTH, 270)).astype(
        np.float32)
    with pytest.raises(ValueError, match="batch axis"):
        serve_ragged(fn, 2)(big)
    got = serve_ragged(fn, 2, axis=1)(big)
    assert got.shape == (2, 5, 5, 10)
    np.testing.assert_allclose(got.numpy(), forward(model, big).numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,quant", [("float32", None),
                                         ("bfloat16", "w8a8")])
def test_artifact_matches_eager_server(detr, dtype, quant):
    model, x, fn = detr
    if dtype != "float32" or quant:
        fn = load_serving(export_serving(
            model, x, serving_dtype=dtype, quant=quant, calib_x=[x],
            platforms=("cpu",)), "cpu")
    server = CSIServer("DETR", copy.deepcopy(model), batch=2, dtype=dtype,
                       device="cpu", quant=quant, calib=x)
    assert_same(fn(x), server(x))


def test_card_and_cpu_w8a8_artifact_holds_the_ops(detr):
    """The CLI's default platforms: the artifact traces the hand kernels
    as ops, so that on the card it launches them; on the CPU the same
    graph runs their plain versions and equals the eager server."""
    model, x, _ = detr
    blob = export_serving(model, x, serving_dtype="bfloat16", quant="w8a8",
                          calib_x=[x], platforms=("cuda", "cpu"))
    ops = graph_ops(blob)
    assert set(ops) == {"quantize_columns", "quantized_product"}, ops
    server = CSIServer("DETR", copy.deepcopy(model), batch=2,
                       dtype="bfloat16", device="cpu", quant="w8a8", calib=x)
    assert_same(load_serving(blob, "cpu")(x), server(x))
