"""Serving artifacts of the port (core/export.py) on the CPU: the ports of
the JAX package's export tests (tests/test_export.py:28-286), the
``mmcsi`` custom ops, and the artifact against the port's eager server.

- An artifact's logits equal the eager forward within 1e-6 of the largest
  logit (one traced program against the same Python code; measured 0).
- A ("cuda",) artifact traced on this CPU host holds the hand kernels as
  ``mmcsi`` ops, by name (JAX: ``tpu_custom_call`` in a TPU-only
  artifact), and so does a ("cuda", "cpu") one; a ("cpu",) one holds
  none. Each program, run here on the ops' CPU implementations (the plain
  versions), equals the eager forward within 1e-6.
- Each op passes ``torch.library.opcheck`` on CPU tensors.
- bf16, int8-input and int8-weight tolerances are JAX's own tests'.
"""

import copy
import io
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.core.export import (
    export_serving, load_artifact, load_serving, save_artifact, serve_file,
    serve_ragged, stored_bytes)
from multi_modal_csi_tpu_torch.core.quantize import quantize_for_serving
from multi_modal_csi_tpu_torch.core.serving import CSIServer
from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
    flash_attention_lowrank_bias)
from multi_modal_csi_tpu_torch.kernels.int8_matmul import quantize_columns
from multi_modal_csi_tpu_torch.models.csi.mlp import MLP
from multi_modal_csi_tpu_torch.nn import layers as L

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
OPS = ("flash_attention", "flash_attention_lowrank_bias", "quantized_product",
       "quantize_columns", "quantize_columns3d")
SAME = 1e-6          # artifact vs eager, of the largest logit


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def tiny_mlp():
    """JAX's tests/test_export.py:19: an MLP of 120 features, out 6, and
    (4, 120) inputs; the input BatchNorm's statistics made non-trivial."""
    model = MLP(6, in_features=120, generator=gen()).eval()
    with torch.no_grad():
        norm = model.layer_norm
        norm.running_mean.normal_(0, 0.1, generator=gen(1))
        norm.running_var.uniform_(0.5, 1.5, generator=gen(2))
    x = np.random.default_rng(0).normal(size=(4, 120)).astype(np.float32)
    return model, x


def forward(model, x):
    with torch.no_grad():
        return model(torch.as_tensor(x)).float()


def assert_same(got, want, share=SAME):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max() <= share * want.abs().max()


def graph_ops(blob):
    """The ``mmcsi`` ops in an artifact's graph, by name, with counts."""
    kernels.register_ops()
    program = torch.export.load(io.BytesIO(blob))
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if str(n.target).startswith("mmcsi."))


def test_export_roundtrip_matches_forward():
    model, x = tiny_mlp()
    fn = load_serving(export_serving(model, x, platforms=("cpu",)), "cpu")
    assert_same(fn(x), forward(model, x))


def test_export_bf16_serving_dtype():
    model, x = tiny_mlp()
    blob = export_serving(model, x, serving_dtype="bfloat16",
                          platforms=("cpu",))
    out = load_serving(blob, "cpu")(x)
    assert out.dtype == torch.float32           # logits: always f32 out
    np.testing.assert_allclose(out.numpy(), forward(model, x).numpy(),
                               rtol=0.1, atol=0.15)
    server = CSIServer("MLP", copy.deepcopy(model), dtype="bfloat16",
                       batch=4, device="cpu")
    assert_same(out, server.forward(torch.from_numpy(x)))


def test_artifact_file_roundtrip(tmp_path):
    model, x = tiny_mlp()
    blob = export_serving(model, x, platforms=("cpu",))
    path = str(tmp_path / "m.mmcsi")
    save_artifact(path, blob, {"model": "MLP", "batch": 4})
    with open(path, "rb") as f:
        head = f.read(20)
    assert head[:12] == b"MMCSI-SERVE\x00"
    assert int.from_bytes(head[12:20], "little") == len(
        b'{"model": "MLP", "batch": 4}')
    blob2, meta = load_artifact(path)
    assert blob2 == blob and meta["model"] == "MLP"
    fn, meta2 = serve_file(path, "cpu")
    assert meta2["batch"] == 4
    assert_same(fn(x), forward(model, x))
    other = tmp_path / "other.bin"
    other.write_bytes(b"not an artifact")
    with pytest.raises(ValueError):
        load_artifact(str(other))


def test_serving_an_artifact_needs_no_model_code(tmp_path):
    """A fresh process serves a saved artifact importing only the export
    module and the kernels: no model, layer, runner or training code."""
    model, x = tiny_mlp()
    path = str(tmp_path / "m.mmcsi")
    save_artifact(path, export_serving(model, x, platforms=("cpu",)))
    code = (
        "import sys, numpy as np\n"
        "from multi_modal_csi_tpu_torch.core.export import serve_file\n"
        f"fn, _ = serve_file({path!r}, 'cpu')\n"
        "out = fn(np.zeros((4, 120), np.float32))\n"
        "parts = ('models', 'nn', 'runners', 'train')\n"
        "print(tuple(out.shape), sorted(m for m in sys.modules if\n"
        "      m.split('.')[:2][-1] in parts and\n"
        "      m.startswith('multi_modal_csi_tpu_torch.')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "(4, 6) []", res.stdout


def test_export_batch_shape_is_static():
    model, x = tiny_mlp()
    fn = load_serving(export_serving(model, x, platforms=("cpu",)), "cpu")
    with pytest.raises(ValueError):
        fn(np.zeros((2, 120), np.float32))


def test_export_bf16_input_contract():
    """input_dtype="bfloat16": the artifact takes bf16 inputs, refuses
    f32, and stays within bf16 rounding of the f32 forward."""
    model, x = tiny_mlp()
    fn = load_serving(export_serving(model, x, input_dtype="bfloat16",
                                     platforms=("cpu",)), "cpu")
    out = fn(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), forward(model, x).numpy(),
                               rtol=0.05, atol=0.05)
    with pytest.raises(ValueError):
        fn(x)


def test_export_quantized_w8():
    """Weight-only int8: the hidden layers int8, the head float; close to
    the f32 forward (JAX's bound: 0.25 of the logits' spread)."""
    model = MLP(6, in_features=1200, generator=gen()).eval()
    x = np.random.default_rng(1).normal(size=(4, 1200)).astype(np.float32)
    out = load_serving(export_serving(model, x, quant="w8",
                                      platforms=("cpu",)), "cpu")(x)
    ref = forward(model, x)
    assert (out - ref).abs().max() / (ref.std() + 1e-9) < 0.25


def test_export_quantized_w8a8_requires_calib():
    model, x = tiny_mlp()
    with pytest.raises(ValueError):
        export_serving(model, x, quant="w8a8", platforms=("cpu",))
    out = load_serving(export_serving(model, x, quant="w8a8", calib_x=[x],
                                      platforms=("cpu",)), "cpu")(x)
    assert out.shape == (4, 6) and bool(torch.isfinite(out).all())


def test_export_int8_input_contract():
    """The host quantizes round(x / scale), the artifact dequantizes in
    its graph; close to the f32 forward (JAX's bound: 0.3 of the spread);
    the scale derived from calib_x gives a working artifact too."""
    model, x = tiny_mlp()
    scale = float(np.max(np.abs(x))) / 127.0
    blob = export_serving(model, x, input_dtype="int8", input_scale=scale,
                          quant="w8", platforms=("cpu",))
    x8 = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    out = load_serving(blob, "cpu")(x8)
    ref = forward(model, x)
    assert (out - ref).abs().max() / (ref.std() + 1e-9) < 0.3
    with pytest.raises(ValueError):
        export_serving(model, x, input_dtype="int8", platforms=("cpu",))
    derived = export_serving(model, x, input_dtype="int8", calib_x=[x],
                             quant="w8", platforms=("cpu",))
    assert torch.equal(load_serving(derived, "cpu")(x8), out)


def test_int8_weight_stored_once():
    """An int8 weight and its padded copy share one storage in the
    artifact: it holds the padded weights, the scales and the float
    parameters once, and little else."""
    model = MLP(6, in_features=1200, generator=gen()).eval()
    x = np.zeros((4, 1200), np.float32)
    blob = export_serving(model, x, quant="w8", platforms=("cpu",))
    served = quantize_for_serving(MLP(6, in_features=1200,
                                      generator=gen()).eval(),
                                  [torch.from_numpy(x)], mode="w8")
    int8 = sum(b.numel() for n, b in served.named_buffers()
               if n.endswith("_padded"))
    floats = sum(t.numel() * t.element_size()
                 for t in served.state_dict().values()
                 if t.dtype != torch.int8)
    assert int8 > 1200 * 256
    assert stored_bytes(blob) == int8 + floats
    assert len(blob) < stored_bytes(blob) + 2 ** 18


def test_artifact_does_not_store_the_example_batch():
    """The example only fixes the shape: an artifact of a serving batch of
    4096 windows is the size of one of 4 (the example batch is 2 MB)."""
    model, _ = tiny_mlp()
    sizes = [len(export_serving(model, np.zeros((n, 120), np.float32),
                                platforms=("cpu",))) for n in (4, 4096)]
    assert abs(sizes[1] - sizes[0]) < 2 ** 12, sizes


class _AllOps(torch.nn.Module):
    """One forward through every serving kernel: attention over 64 tokens
    (K1), a low-rank-bias attention (K3), a w8a8 Linear (the prologue and
    P1's s8 product), a w8 Linear on a bf16 activation (P1's bf16 product)
    and a hooked w8a8 Conv3d (the 3-D prologue)."""

    def __init__(self):
        super().__init__()
        g = gen(3)
        self.attn = L.MultiheadAttention(32, 2, generator=g)
        self.r = torch.nn.Parameter(torch.randn(1, 2, 64, 5, generator=g))
        self.s = torch.nn.Parameter(torch.randn(5, 64, generator=g))
        self.s8 = L.Linear(32, 160, generator=g)
        self.w8 = L.Linear(160, 128, generator=g)
        self.conv = L.Conv3d(4, 8, (3, 3, 3), padding=(1, 1, 1),
                             hooked=True, generator=g)

    def forward(self, x):
        h = self.attn(x, x, x)                                  # (1, 64, 32)
        q = h.reshape(1, 64, 2, 16).transpose(1, 2).contiguous()
        a = flash_attention_lowrank_bias(q, q, q, self.r, self.s)
        h = h + a.transpose(1, 2).reshape(1, 64, 32)
        h = self.w8(self.s8(h).to(torch.bfloat16)).float()      # (1, 64, 128)
        v = self.conv(h.reshape(1, 8, 16, 16, 4))
        return v.sum() + h.sum(dim=1)


@pytest.fixture(scope="module")
def all_ops():
    model = _AllOps().eval().requires_grad_(False)
    x = torch.randn(1, 64, 32, generator=gen(4))
    quantize_for_serving(model, [x], mode="w8a8", min_size=1)
    # the w8 layer: weight-only (no input scale), fed bf16 directly
    del model.w8.input_scale
    return model, x


@pytest.mark.parametrize("platforms,holds", [
    (("cuda",), True), (("cuda", "cpu"), True), (("cpu",), False)])
def test_platforms_decide_the_kernels_in_the_graph(all_ops, platforms,
                                                   holds):
    """JAX's test_export_tpu_only_traces_mosaic_flash, mirrored: an
    artifact that may run on the card, traced on this host, holds each
    ``mmcsi`` op (they dispatch by device at run time); one for the CPU
    alone holds none. Each program, run here, equals the eager forward."""
    model, x = all_ops
    blob = export_serving(model, x, platforms=platforms)
    ops = graph_ops(blob)
    if holds:
        assert set(ops) == set(OPS), ops
    else:
        assert not ops, ops
    program = torch.export.load(io.BytesIO(blob)).module()
    with torch.no_grad():
        assert_same(program(x), forward(model, x))


def test_card_artifact_refuses_the_cpu(all_ops):
    model, x = all_ops
    blob = export_serving(model, x, platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        load_serving(blob, "cpu")
    with pytest.raises(ValueError):
        export_serving(model, x, platforms=("tpu",))


def test_ops_everywhere_scoping():
    """The wrappers' switch (JAX's flash_mode): outside it the op on CUDA
    tensors only, inside it on any device; scoped and nestable, and a
    CUDA tensor takes the op either way."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not kernels.uses_op(cpu) and kernels.uses_op(cuda)
    with kernels.ops_everywhere():
        assert kernels.uses_op(cpu) and kernels.uses_op(cuda)
        with kernels.ops_everywhere():
            assert kernels.uses_op(cpu)
        assert kernels.uses_op(cpu)
    assert not kernels.uses_op(cpu) and kernels.uses_op(cuda)


def _op_cases():
    g = gen(5)
    q, k = torch.randn(2, 70, 3, 16, generator=g), torch.randn(
        2, 65, 3, 16, generator=g)
    lq, lk = torch.randn(2, 2, 70, 16, generator=g), torch.randn(
        2, 2, 65, 16, generator=g)
    r, s = torch.randn(2, 2, 70, 5, generator=g), torch.randn(5, 65,
                                                              generator=g)
    x, scale = torch.randn(2, 30, 12, generator=g), torch.tensor(0.02)
    a = quantize_columns(torch.randn(1, 40, 30, generator=g), scale)[:, 0]
    w = torch.randint(-127, 128, (20, 32), dtype=torch.int8, generator=g)
    ws = torch.rand(20, generator=g)
    return {
        "flash_attention": (q, k, k.clone()),
        "flash_attention_lowrank_bias": (lq, lk, lk.clone(), r, s),
        "flash_attention_lowrank_bias-nobias": (lq, lk, lk.clone(), None,
                                                None),
        "quantize_columns": (x, scale, 3, 2, 1, [1, 1], 2),
        "quantize_columns-bf16": (x.bfloat16(), None, 1, 1, 1, [0, 0], 1),
        "quantize_columns3d": (torch.randn(2, 4, 6, 6, 3, generator=g),
                               scale, [3, 3, 3], [1, 2, 2], [1, 1, 1]),
        "quantized_product": (a, w, ws, scale, torch.randn(20, generator=g),
                              torch.float32, 30),
        "quantized_product-bf16": (torch.randn(40, 32, generator=g)
                                   .bfloat16(), w, ws, None, None,
                                   torch.bfloat16, 30),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_opcheck(case):
    op = getattr(torch.ops.mmcsi, case.split("-")[0]).default
    torch.library.opcheck(op, _op_cases()[case])


def test_serve_ragged():
    """The ragged shim around a (B, C) artifact: full batches, the last
    zero-padded and cut (test_torch_export_serving.py holds DETR's)."""
    model, x = tiny_mlp()
    fn = load_serving(export_serving(model, x, platforms=("cpu",)), "cpu")
    big = np.random.default_rng(3).normal(size=(10, 120)).astype(np.float32)
    assert_same(serve_ragged(fn, 4)(big), forward(model, big))
