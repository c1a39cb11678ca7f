"""The int8 convs of the port's video backbones and CNN-2D on the CPU,
against the JAX package's int8 serving (core/quantize.py and the
``Conv3D`` / ``Conv2d`` wrappers there).

- The 3-D columns: ``kernels/int8_matmul.py::quantize_columns3d_reference``
  (the plain version of the 3-D prologue) at ResNet3D's stem (3, 7, 7) /
  (1, 2, 2) over 3 channels, a 3x3x3 stride-2 conv, a 1x1x1 stride-2
  downsample, S3D's (1, k, k) and (k, 1, 1) convs and its stride-2
  (7, 1, 1) stem, and CNN-2D's stages 1 and 2 as 2-D convs (T = 1): the
  int8 codes equal JAX's ``quantize_activation`` unfolded in the weight's
  (channel, kt, kh, kw) order, and the int32 product of those columns
  with the int8 weight equals ``lax.conv_general_dilated`` on the int8
  codes, bit for bit; the bf16 (w8) columns equal the input cast to bf16,
  unfolded.
- ``core/quantize.py::conv_nd_forward`` with the column budget so small
  that every sample is a chunk equals the unchunked product bit for bit,
  in w8a8 and w8.
- ResNet3D-18 in w8 within 0.35 of the float logits' spread (the JAX
  package's bound, tests/test_quantize.py::test_resnet3d_quantized_close,
  at its input), with at least 10 int8 convs.
- ResNet3D-18 and S3D in w8a8 against the JAX package's w8a8 of the same
  float weights and calibration clips: the same int8 weights, weight
  scales and input scales (test_torch_port_quantize.py's
  ``assert_same_quantization``: int8 and weight scales equal, input
  scales within 1e-5 relative), the hooked set (every conv and the 400-way
  Linear at least 16,384 weights large), and the logits within 2e-2 of the
  largest logit, as DETR's (f32 noise flips a few activations across an
  int8 rounding boundary between the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
from multi_modal_csi_tpu_torch.runners import video
from test_torch_port_quantize import assert_same_quantization
from test_torch_port_video_backbones import jax_variables, models

torch.set_num_threads(1)

W8A8_TOL = 2e-2          # of the largest logit
W8_SPREAD_BOUND = 0.35   # of the float logits' spread (JAX's bound)
# name: (x (B, T, H, W, C), N, kernel, stride, pads)
CONVS = {
    "resnet-stem": ((2, 4, 20, 20, 3), 16, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
    "resnet-3x3x3-s2": ((2, 5, 9, 9, 16), 24, (3, 3, 3), (2, 2, 2),
                        (1, 1, 1)),
    "resnet-downsample": ((2, 5, 9, 9, 16), 24, (1, 1, 1), (2, 2, 2),
                          (0, 0, 0)),
    "s3d-spatial": ((2, 3, 10, 10, 12), 20, (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    "s3d-temporal": ((2, 6, 5, 5, 20), 20, (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    "s3d-stem-temporal": ((1, 9, 6, 6, 8), 8, (7, 1, 1), (2, 1, 1),
                          (3, 0, 0)),
    "cnn2d-stage1": ((2, 1, 40, 35, 4), 8, (1, 15, 15), (1, 3, 3),
                     (0, 0, 0)),
    "cnn2d-stage2": ((2, 1, 19, 7, 8), 16, (1, 7, 7), (1, 1, 1), (0, 0, 0)),
}


def operands(name, seed=0):
    shape, n, kernel, stride, pads = CONVS[name]
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.integers(-127, 128, (n, shape[-1], *kernel)).astype(np.int8)
    return x, w, kernel, stride, pads


def numpy_columns3d(xq, kernel, stride, pads):
    """The im2col of channels-last xq (B, T, H, W, C): (B To Ho Wo,
    C kt kh kw) in the (channel, kt, kh, kw) order of the weight."""
    xp = np.pad(xq, ((0, 0), *[(p, p) for p in pads], (0, 0)))
    dims = [(xp.shape[1 + i] - kernel[i]) // stride[i] + 1 for i in range(3)]
    taps = []
    for dt in range(kernel[0]):
        for dh in range(kernel[1]):
            for dw in range(kernel[2]):
                taps.append(xp[:, dt:dt + (dims[0] - 1) * stride[0] + 1:
                               stride[0],
                               dh:dh + (dims[1] - 1) * stride[1] + 1:
                               stride[1],
                               dw:dw + (dims[2] - 1) * stride[2] + 1:
                               stride[2]])
    cols = np.stack(taps, axis=-1)          # (B, To, Ho, Wo, C, taps)
    return cols.reshape(-1, xq.shape[-1] * len(taps))


def jax_conv3d_int32(xq, w, stride, pads):
    """JAX's w8a8 conv product: int8 codes, the DHWIO int8 kernel, int32
    sums."""
    kernel = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))
    dn = jax.lax.conv_dimension_numbers(xq.shape, kernel.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), kernel, window_strides=stride,
        padding=[(p, p) for p in pads], dimension_numbers=dn,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("name", sorted(CONVS))
def test_columns3d_match_jax(name):
    x, w, kernel, stride, pads = operands(name)
    scale = np.float32(0.05)
    xq = np.asarray(qz.quantize_activation(jnp.asarray(x),
                                           jnp.asarray(scale)))
    want = numpy_columns3d(xq, kernel, stride, pads)
    k = want.shape[1]
    cols = K.quantize_columns3d(torch.from_numpy(x), torch.tensor(scale),
                                kernel, stride, pads)
    assert cols.dtype == torch.int8
    assert cols.shape == (want.shape[0], K.padded_width(k, torch.int8))
    np.testing.assert_array_equal(cols[:, :k].numpy(), want)
    assert not cols[:, k:].any()
    got = K.int8_matmul(cols, K.pad_columns(torch.from_numpy(
        w.reshape(w.shape[0], -1))))
    want_sum = jax_conv3d_int32(xq, w, stride, pads)
    np.testing.assert_array_equal(got.numpy(),
                                  want_sum.reshape(-1, w.shape[0]))
    bf = K.quantize_columns3d(torch.from_numpy(x), None, kernel, stride,
                              pads)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf[:, :k].float().numpy(),
                                  numpy_columns3d(xb, kernel, stride, pads))


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_column_budget_chunks_bit_for_bit(mode, monkeypatch):
    """Chunks of one sample (a budget below one sample's columns) against
    one chunk, with a bias and a bf16 output."""
    x, w, kernel, stride, pads = operands("resnet-3x3x3-s2", seed=1)
    xt = torch.from_numpy(x)
    if mode == "w8":
        xt = xt.to(torch.bfloat16)
    ws = torch.from_numpy(np.random.default_rng(2).uniform(
        1e-3, 1e-2, w.shape[0]).astype(np.float32))
    bias = torch.linspace(-1, 1, w.shape[0])
    s = torch.tensor(0.05) if mode == "w8a8" else None
    args = dict(stride=stride, padding=pads, bias=bias,
                out_dtype=torch.bfloat16)
    whole = Q.conv_nd_forward(xt, torch.from_numpy(w), ws, s, **args)
    calls = []
    real = Q.quantize_columns3d
    monkeypatch.setattr(Q, "quantize_columns3d",
                        lambda x, *a: calls.append(len(x)) or real(x, *a))
    monkeypatch.setattr(Q, "COLUMN_BUDGET", 1)
    chunked = Q.conv_nd_forward(xt, torch.from_numpy(w), ws, s, **args)
    assert calls == [1, 1]
    dims = K.conv3d_output(x.shape[1:4], kernel, stride, pads)
    assert whole.shape == (2, *dims, w.shape[0])
    assert torch.equal(whole, chunked)


def quantized_pair(key, mode, x):
    """(port model quantized, JAX model, JAX's quantized variables) from
    the same float weights and calibration clips."""
    port, jmodel = models(key)
    variables = jax_variables(key, port)
    qv = qz.quantize_for_serving(jmodel, variables, [x], mode=mode,
                                 train=False)
    Q.quantize_for_serving(port.eval(), [torch.from_numpy(x)], mode=mode)
    return port, jmodel, qv


def test_resnet3d_w8_within_jax_bound():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(8),
                                     (2, 8, 32, 32, 3)))
    model = video.build_video_model("ResNet", 9, (8, 32, 32), seed=0)
    with torch.no_grad():
        y32 = model(torch.from_numpy(x)).numpy()
        Q.quantize_for_serving(model, [torch.from_numpy(x)], mode="w8")
        yq = model(torch.from_numpy(x)).numpy()
    convs = [n for n, p in model.named_parameters()
             if p.dtype == torch.int8 and ".0.weight" in n]
    assert len(convs) >= 10, convs
    rel = np.abs(yq - y32).max() / (y32.std() + 1e-9)
    print(f"ResNet w8: {rel:.4f} of the float logits' spread")
    assert rel < W8_SPREAD_BOUND


@pytest.mark.parametrize("key", ["ResNet", "S3D"])
def test_w8a8_matches_jax(key):
    x = np.random.default_rng(9).standard_normal(
        (2, *(8, 32, 32), 3)).astype(np.float32)
    port, jmodel, qv = quantized_pair(key, "w8a8", x)
    sd = port.state_dict()
    assert_same_quantization(sd, state_dict_from_jax(key, qv))
    hooked = {n[:-len(".weight")] for n, p in port.named_parameters()
              if n.endswith("weight") and p.dim() > 1
              and p.numel() >= Q.DEFAULT_MIN_WEIGHT_SIZE
              and "task_head" not in n}
    int8 = {n[:-len(".weight")] for n, v in sd.items()
            if v.dtype == torch.int8}
    assert int8 == hooked
    assert int8 == {n[:-len(".input_scale")] for n in sd
                    if n.endswith("input_scale")}
    want = np.asarray(jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False))(qv, x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max()
    print(f"{key} w8a8: {len(int8)} int8 layers, logits {err:.3e} of "
          f"{np.abs(want).max():.4f}")
    assert err <= W8A8_TOL * np.abs(want).max()
