"""The implicit int8 conv of the port (kernels/int8_matmul.py::
quantized_conv3d and its plain version; core/quantize.py::conv_nd_forward's
routing, conv_codes and the tap-major weight copy) on the CPU, where the
wrappers take their plain versions, against the JAX package's int8 conv
(core/quantize.py::conv_forward, quantize_activation and
lax.conv_general_dilated on the int8 codes) on the same seeded numpy inputs.

- Against JAX, bit for bit: the codes of the k = 1 prologue (JAX's
  ``quantize_activation``, channels-last, zero-padded to a multiple of 16
  bytes), the int32 sums of the tap-major columns that the kernel reads
  against the tap-major weight (JAX's int8 ``conv_general_dilated``), and
  the w8a8 output with the rescale (JAX's ``conv_forward`` called through
  a flax module) exactly, at (3, 3, 3) strides 1 and 2, the (1, 1, 1)
  stride-2 shortcut, S3D's (1, 3, 3), (3, 1, 1) and stride-2 (7, 1, 1),
  and CNN-2D's 2-D case (T = 1), with C of 16, 24, 32 and 64, odd T, H
  and W, batch 2. w8 (the bf16 values) within P1's f32 summation bound of
  JAX's w8 ``conv_forward``.
- Against the columns path (the 3-D prologue and the product, taken when
  the routing threshold is raised past C): w8a8 bit for bit with a bias
  and either output type; w8 within twice P1's bf16 bound (two f32 sums
  of the same products in two orders), plus the rescale's rounding.
- The routing: in a small ResNet3D-18, S3D and CNN-2D (w8a8, and CNN-2D
  in w8), the stems' C = 3 convs take the 3-D prologue and every other
  int8 conv the implicit conv, one call a conv; a w8 bf16 activation of C
  a multiple of 8 is read as it is (no prologue).
- The tap-major copy: it round-trips through ``tap_major_view``, holds
  zeros in every pad, stays out of the state dict, and ``load_quantized``
  rebuilds it (w8a8 at Cp = 32 and w8 at Cp = 24 for C = 24).
- Export: a small ResNet3D-18 w8a8 exported for the CPU, and for
  ``cuda,cpu`` (holding ``mmcsi::quantized_conv3d``, run here on its CPU
  implementation), gives the eager logits; each int8 weight is stored once.
- The op: ``torch.library.opcheck`` on CPU tensors, its fake
  implementation's shape and dtype, and the wrapper's refusals.
"""

import copy
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.core.export import (export_serving,
                                                   load_serving,
                                                   stored_bytes)
from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
from multi_modal_csi_tpu_torch.models.csi.cnn_2d import CNN2D
from multi_modal_csi_tpu_torch.nn import layers as L
from multi_modal_csi_tpu_torch.runners import video

torch.set_num_threads(1)

SCALE = np.float32(0.05)
P1_BF16 = 2.0 ** -24      # P1's bf16 bound: K 2^-24 sum |a b| (f32 sums)
# name: (x (B, T, H, W, C), N, kernel, stride, pads)
CONVS = {
    "3x3x3-s1": ((2, 5, 7, 9, 16), 24, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "3x3x3-s2": ((2, 5, 9, 7, 24), 16, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "shortcut": ((2, 5, 9, 7, 64), 32, (1, 1, 1), (2, 2, 2), (0, 0, 0)),
    "s3d-spatial": ((2, 3, 9, 11, 24), 20, (1, 3, 3), (1, 1, 1),
                    (0, 1, 1)),
    "s3d-temporal": ((2, 7, 5, 3, 64), 16, (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    "s3d-stem-temporal": ((2, 9, 3, 5, 64), 24, (7, 1, 1), (2, 1, 1),
                          (3, 0, 0)),
    "cnn2d": ((2, 1, 23, 19, 32), 16, (1, 7, 7), (1, 3, 3), (0, 0, 0)),
}


def operands(name, seed=0):
    shape, n, kernel, stride, pads = CONVS[name]
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[:8] = (np.arange(-4, 4) + 0.5) * SCALE   # ties
    w = rng.integers(-127, 128, (n, shape[-1], *kernel)).astype(np.int8)
    ws = (1e-3 + 1e-2 * rng.random(n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, w, ws, bias, kernel, stride, pads


class _JaxConv(fnn.Module):
    """JAX's own conv_forward on an int8 DHWIO kernel, with kernel_scale
    (and input_scale for w8a8) given as params."""
    stride: tuple = (1, 1, 1)
    pads: tuple = (0, 0, 0)

    @fnn.compact
    def __call__(self, x, kernel):
        dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape,
                                            ("NDHWC", "DHWIO", "NDHWC"))
        return qz.conv_forward(self, x, kernel, window_strides=self.stride,
                               padding=[(p, p) for p in self.pads],
                               rhs_dilation=(1, 1, 1), dimension_numbers=dn,
                               feature_group_count=1)


def jax_conv(x, w, ws, stride, pads, scale=None):
    params = {"kernel_scale": jnp.asarray(ws)}
    if scale is not None:
        params["input_scale"] = jnp.asarray(scale)
    kernel = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))
    return np.asarray(_JaxConv(stride, pads).apply({"params": params},
                                                   jnp.asarray(x), kernel))


def jax_int32(xq, w, stride, pads):
    kernel = jnp.asarray(np.transpose(w, (2, 3, 4, 1, 0)))
    dn = jax.lax.conv_dimension_numbers(xq.shape, kernel.shape,
                                        ("NDHWC", "DHWIO", "NDHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), kernel, window_strides=stride,
        padding=[(p, p) for p in pads], dimension_numbers=dn,
        preferred_element_type=jnp.int32))


def f32_bound(cols, taps, ws, k):
    """P1's bf16 bound on the f32 sums, K 2^-24 sum |a b|, times the
    scale, plus the rescale's rounding (2^-23 of the value)."""
    mag = cols[:, :k].double().abs() @ taps[:, :k].double().abs().T
    return (k * P1_BF16 * mag * ws.double()).numpy()


@pytest.mark.parametrize("name", sorted(CONVS))
def test_implicit_conv_matches_jax(name):
    x, w, ws, _, kernel, stride, pads = operands(name)
    c, n = x.shape[-1], w.shape[0]
    xq = np.asarray(qz.quantize_activation(jnp.asarray(x),
                                           jnp.asarray(SCALE)))
    s = torch.tensor(SCALE)
    codes = Q.conv_codes(torch.from_numpy(x), s)
    cp = K.padded_width(c, torch.int8)
    assert codes.dtype == torch.int8 and codes.shape == (*x.shape[:-1], cp)
    np.testing.assert_array_equal(codes[..., :c].numpy(), xq)
    assert not codes[..., c:].any()
    taps = K.tap_major(torch.from_numpy(w), cp)
    k = int(np.prod(kernel)) * cp
    sums = K.int8_matmul(K.conv3d_columns(codes, kernel, stride, pads),
                         taps[:, :k])
    want_sums = jax_int32(xq, w, stride, pads)
    np.testing.assert_array_equal(sums.reshape(want_sums.shape).numpy(),
                                  want_sums)
    want = jax_conv(x, w, ws, stride, pads, SCALE)
    got = K.quantized_conv3d(codes, taps, torch.from_numpy(ws), s, None,
                             torch.float32, kernel, stride, pads)
    np.testing.assert_array_equal(got.numpy(), want)
    layer = Q.conv_nd_forward(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(ws), s, stride=stride,
                              padding=pads)
    assert torch.equal(layer, got)
    # w8: the bf16 values, f32 sums, within P1's bound of JAX's
    bf = Q.conv_codes(torch.from_numpy(x), None)
    assert bf.dtype == torch.bfloat16 and bf.shape[-1] == K.padded_width(
        c, torch.bfloat16)
    taps8 = K.tap_major(torch.from_numpy(w), bf.shape[-1])
    got8 = K.quantized_conv3d(bf, taps8, torch.from_numpy(ws), None, None,
                              torch.float32, kernel, stride, pads)
    want8 = jax_conv(x, w, ws, stride, pads)
    k8 = int(np.prod(kernel)) * bf.shape[-1]
    tol = f32_bound(K.conv3d_columns(bf, kernel, stride, pads), taps8,
                    torch.from_numpy(ws), k8).reshape(want8.shape)
    assert np.all(np.abs(got8.numpy() - want8)
                  <= tol + 2.0 ** -23 * np.abs(want8)), name
    assert got8.shape == (*want8.shape[:-1], n)


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
@pytest.mark.parametrize("name", ["3x3x3-s2", "s3d-spatial", "cnn2d"])
def test_implicit_conv_matches_columns_path(name, mode, monkeypatch):
    x, w, ws, bias, kernel, stride, pads = operands(name, seed=3)
    xt = torch.from_numpy(x)
    if mode == "w8":
        xt = xt.to(torch.bfloat16)
    s = torch.tensor(SCALE) if mode == "w8a8" else None
    args = (xt, torch.from_numpy(w), torch.from_numpy(ws), s)
    for out_dtype in (torch.float32, torch.bfloat16):
        kw = dict(stride=stride, padding=pads, out_dtype=out_dtype,
                  bias=torch.from_numpy(bias))
        implicit = Q.conv_nd_forward(*args, **kw)
        with monkeypatch.context() as m:
            m.setattr(Q, "IMPLICIT_MIN_CHANNELS", 10 ** 6)
            columns = Q.conv_nd_forward(*args, **kw)
        assert implicit.shape == columns.shape and implicit.dtype == out_dtype
        if mode == "w8a8":
            assert torch.equal(implicit, columns), (name, out_dtype)
            continue
        a = Q.conv_codes(xt, None)
        cp = a.shape[-1]
        k = int(np.prod(kernel)) * cp
        tol = 2 * f32_bound(K.conv3d_columns(a, kernel, stride, pads),
                            K.tap_major(torch.from_numpy(w), cp),
                            torch.from_numpy(ws), k)
        diff = (implicit.double() - columns.double()).abs().reshape(
            tol.shape).numpy()
        step = 2.0 ** -23 if out_dtype == torch.float32 else 2.0 ** -7
        assert np.all(diff <= tol + step * columns.double().abs().reshape(
            tol.shape).numpy()), (name, out_dtype)


def int8_paths(model, x, monkeypatch):
    """The path each int8 conv of ``model`` took in one forward of x:
    module name -> "implicit" or "columns" (a chunk each); the prologue
    calls at k = 1 by module; the convs whose input was contiguous."""
    names = {m: n for n, m in model.named_modules()}
    current, paths, passes, contiguous = [], {}, [], set()

    def hook(module, args):
        current[:] = [names[module]]
        if args[0].is_contiguous():
            contiguous.add(names[module])
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if getattr(m, "weight", None) is not None
             and m.weight.dtype == torch.int8]
    real3d, real_conv = Q.quantize_columns3d, Q.quantized_conv3d
    real_columns = Q.quantize_columns

    def columns3d(*a):
        paths.setdefault(current[0], []).append("columns")
        return real3d(*a)

    def conv(*a):
        paths.setdefault(current[0], []).append("implicit")
        return real_conv(*a)

    def columns(x, *a):
        passes.append(current[0] if current else None)
        return real_columns(x, *a)
    monkeypatch.setattr(Q, "quantize_columns3d", columns3d)
    monkeypatch.setattr(Q, "quantized_conv3d", conv)
    monkeypatch.setattr(Q, "quantize_columns", columns)
    with torch.no_grad():
        y = model(x)
    for h in hooks:
        h.remove()
    return y, paths, passes, contiguous


RESNET_CLIP = (4, 32, 32)


@pytest.fixture(scope="module")
def resnet():
    """A float ResNet3D-18 for RESNET_CLIP, which each test copies."""
    return video.build_video_model("ResNet", 9, RESNET_CLIP, seed=0).eval()


@pytest.mark.parametrize("key", ["ResNet", "S3D", "CNN-2D", "CNN-2D-w8"])
def test_routing(key, resnet, monkeypatch):
    """Which int8 convs take which path, one call each; the copy that each
    keeps beside its weight."""
    mode = "w8" if key.endswith("w8") else "w8a8"
    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(4)
    if key.startswith("CNN-2D"):
        model = CNN2D(9, generator=g).eval()
        x = torch.from_numpy(rng.standard_normal((2, 251, 251))
                             .astype(np.float32))
        stems = set()
    else:
        clip = RESNET_CLIP if key == "ResNet" else (8, 32, 32)
        model = (copy.deepcopy(resnet) if key == "ResNet"
                 else video.build_video_model(key, 9, clip, seed=0))
        x = torch.from_numpy(rng.standard_normal((2, *clip, 3))
                             .astype(np.float32))
        stems = {"ResNet": {"backbone.stem.0"},
                 "S3D": {"backbone.features.0.0.0"}}[key]
    if mode == "w8":
        model = model.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
    Q.quantize_for_serving(model, [x], mode=mode)
    convs = {n: m for n, m in model.named_modules()
             if isinstance(m, (L.Conv2d, L.Conv3d))
             and m.weight.dtype == torch.int8}
    assert len(convs) >= (2 if key.startswith("CNN") else 10)
    _, paths, passes, contiguous = int8_paths(model, x, monkeypatch)
    want = {n: ["columns"] if n in stems else ["implicit"] for n in convs}
    assert paths == want
    for n, m in convs.items():
        wide = m.weight.shape[1] >= K.IMPLICIT_MIN_CHANNELS
        assert wide == (n not in stems)
        assert hasattr(m, "weight_taps") == wide
        assert hasattr(m, "weight_padded") == (not wide)
    implicit = [n for n in convs if n not in stems]
    if mode == "w8":            # bf16 channels of 32 and 64: read as they are
        implicit = [n for n in implicit if n not in contiguous]
        assert len(implicit) < 2
    # one k = 1 prologue a conv that needs one (the Linears' beside them)
    assert [p for p in passes if p in convs] == implicit


@pytest.mark.parametrize("mode", ["w8a8", "w8"])
def test_tap_major_copy(mode):
    g = torch.Generator().manual_seed(1)
    model = torch.nn.Sequential(
        L.Conv3d(4, 24, (1, 3, 3), padding=(0, 1, 1), hooked=True,
                 generator=g),
        L.Conv3d(24, 40, (3, 3, 1), stride=(2, 1, 1), padding=(1, 1, 0),
                 hooked=True, generator=g)).eval()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 5, 6, 7, 4)).astype(np.float32))
    Q.quantize_for_serving(model, [x], mode=mode, min_size=1)
    narrow, wide = model
    cp = 32 if mode == "w8a8" else 24
    taps = wide.weight_taps
    assert taps.shape == (40, K.padded_width(9 * cp, torch.int8))
    per_tap = taps[:, :9 * cp].reshape(40, 3, 3, 1, cp)
    assert not per_tap[..., 24:].any() and not taps[:, 9 * cp:].any()
    view = K.tap_major_view(taps, wide.weight.shape)
    assert view.shape == wide.weight.shape and torch.equal(view, wide.weight)
    assert view.untyped_storage().data_ptr() == taps.untyped_storage(
    ).data_ptr()
    assert hasattr(narrow, "weight_padded")
    assert not hasattr(narrow, "weight_taps")
    state = model.state_dict()
    assert not any(n.endswith(("_taps", "_padded")) for n in state)
    g = torch.Generator().manual_seed(1)
    fresh = torch.nn.Sequential(
        L.Conv3d(4, 24, (1, 3, 3), padding=(0, 1, 1), hooked=True,
                 generator=g),
        L.Conv3d(24, 40, (3, 3, 1), stride=(2, 1, 1), padding=(1, 1, 0),
                 hooked=True, generator=g)).eval()
    loaded = Q.load_quantized(fresh, state)
    assert torch.equal(loaded[1].weight_taps, taps)
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))


@pytest.mark.parametrize("platforms", [("cpu",), ("cuda", "cpu")])
def test_export_resnet_w8a8(resnet, platforms):
    model = resnet
    x = np.random.default_rng(6).standard_normal(
        (2, *RESNET_CLIP, 3)).astype(np.float32)
    blob = export_serving(model, x, quant="w8a8", calib_x=[x],
                          platforms=platforms)
    eager = Q.quantize_for_serving(copy.deepcopy(model),
                                   [torch.from_numpy(x)], mode="w8a8")
    with torch.no_grad():
        want = eager(torch.from_numpy(x)).float()
    kernels.register_ops()
    program = torch.export.load(io.BytesIO(blob))
    ops = {str(n.target).split(".")[1] for n in program.graph.nodes
           if str(n.target).startswith("mmcsi.")}
    if "cuda" in platforms:
        assert {"quantized_conv3d", "quantize_columns3d",
                "quantize_columns", "quantized_product"} <= ops
    else:
        assert not ops
    got = load_serving(blob, "cpu")(x)
    assert got.shape == want.shape and torch.equal(got, want)
    # one storage a weight: the tap-major or padded copies, the rest float
    copies = sum(b.numel() for n, b in eager.named_buffers()
                 if n.endswith(("_taps", "_padded")))
    floats = sum(t.numel() * t.element_size()
                 for t in eager.state_dict().values()
                 if t.dtype != torch.int8)
    assert stored_bytes(blob) == copies + floats


def op_case(dtype=torch.int8):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 5, 4, 3, 24, generator=g)
    s = torch.tensor(0.05) if dtype == torch.int8 else None
    a = Q.conv_codes(x if s is not None else x.bfloat16(), s)
    w = torch.randint(-127, 128, (12, 24, 3, 1, 3), dtype=torch.int8,
                      generator=g)
    taps = K.tap_major(w, a.shape[-1])
    return (a, taps, torch.rand(12, generator=g), s,
            torch.randn(12, generator=g), torch.bfloat16, [3, 1, 3],
            [1, 1, 2], [1, 0, 1])


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_op_and_fake(dtype):
    args = op_case(dtype)
    op = torch.ops.mmcsi.quantized_conv3d.default
    torch.library.opcheck(op, args)
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(t) if isinstance(t, torch.Tensor)
                    else t for t in args))
    assert fake.shape == (2, 5, 4, 2, 12) and fake.dtype == torch.bfloat16
    assert op(*args).shape == fake.shape


def test_refusals():
    a, taps, ws, s, bias, out_dtype, kernel, stride, pads = op_case()
    conv = K.quantized_conv3d
    with pytest.raises(ValueError, match="rows of at least"):
        conv(a[..., :8].contiguous(), taps, ws, s, bias, out_dtype, kernel,
             stride, pads)
    with pytest.raises(ValueError, match="tap-major"):
        conv(a, taps[:, :-16], ws, s, bias, out_dtype, kernel, stride, pads)
    with pytest.raises(ValueError, match="input scale"):
        conv(a, taps, ws, None, bias, out_dtype, kernel, stride, pads)
    wide = torch.zeros((1, 2, 2, 2, 5120), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflow"):
        conv(wide, torch.zeros((4, 27 * 5120), dtype=torch.int8),
             torch.ones(4), s, None, out_dtype, (3, 3, 3), (1, 1, 1),
             (1, 1, 1))
