"""The port's CSI serving (core/serving.py, cli/serve_csi.py) on the CPU,
and the port's independence from JAX.

bf16 serving is held against the JAX package's bf16 serving
(``cast_for_serving`` + apply, f32 logits) on the same variables and
(2, 3000, 270) windows. Both round at different places (JAX sums the
20-step average pool in bf16, PyTorch in f32; bf16 products round once
or twice), so the tolerance is 2% of the largest f32 logit: measured, the
port stays within 0.6% (THAT) and 1.3% (DETR), while JAX's own bf16 logits
differ from its f32 ones by 0.6% and 2.0%.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu_torch.cli import serve_csi
from multi_modal_csi_tpu_torch.core.serving import CSIServer, cast_for_serving
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.runners.csi import build_model
from test_torch_port_layers import run, to_torch
from test_torch_port_that import (jax_forward, jax_model_and_variables,
                                  windows)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("key", ["THAT", "DETR"])
def test_bf16_serving_matches_jax_bf16_serving(key):
    x = windows()
    port = build_model(key, seed=0)
    jmodel, variables = jax_model_and_variables(key, port)
    f32 = jax_forward(jmodel, variables, x)
    jvars = jax_cast(jax.tree_util.tree_map(jnp.asarray, variables),
                     jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x.astype(jnp.bfloat16), train=False).astype(jnp.float32))(
            jvars, x))
    port.load_state_dict(state_dict_from_jax(key, variables), strict=True)
    server = CSIServer(key, port, dtype="bfloat16", device="cpu", batch=2)
    got = server(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 0.02 * np.abs(f32).max()


@pytest.mark.parametrize("key,axis", [("THAT", 0), ("DETR", 1)])
def test_ragged_request_matches_unbatched_forward(key, axis):
    """5 windows at serving batch 4: a full batch plus a zero-padded one
    whose padding is cut along the model's output batch axis."""
    x = windows(5, seed=3)
    model = build_model(key, seed=0)
    want = run(model, to_torch(x)).numpy()
    server = CSIServer(key, model, batch=4, dtype="float32", device="cpu")
    got = server(x).numpy()
    assert got.shape == want.shape and got.shape[axis] == 5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cast_for_serving_casts_state_not_constants():
    model = cast_for_serving(build_model("THAT", seed=0), torch.bfloat16)
    blk = model.layer_left_encoder[0].layer_cnn[0][1]
    assert blk.running_var.dtype == torch.bfloat16
    assert model.layer_output.weight.dtype == torch.bfloat16
    assert model.layer_left_gaussian.var_position.dtype == torch.float32


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CSIServer("THAT", build_model("THAT", seed=0))


def test_serve_cli_on_cpu(capsys):
    serve_csi.main(["--model", "THAT_COUNT", "--device", "cpu",
                    "--requests", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert "request of 3 windows -> logits (3, 9)" in out
    assert "windows/s" in out


def test_port_imports_nothing_of_jax():
    """Importing every port module and chip_smoke.py loads no jax, flax,
    optax, multi_modal_csi_tpu or tools module (the port's own package
    name starts with the JAX package's, so names are compared exactly),
    and no pandas, sklearn, cv2, msgpack or matplotlib, which the machine
    with the card does not have. The video, int8, checkpoint, transfer,
    SSL, dual-band, ST-RF, export, parallel and entry modules are named,
    so that the test fails if one of them goes missing; the parallel modules,
    imported first, load nothing of the port outside ``parallel`` (they
    import torch.distributed only)."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "multi_modal_csi_tpu_torch").rglob("*.py"))
    for video_module in ("models.video.mvit", "kernels.flash_attention_lowrank",
                         "data.video_io", "runners.video", "cli.serve_video",
                         "cli.run_video", "core.quantize",
                         "kernels.int8_matmul", "core.checkpoint",
                         "train.transfer", "models.csi.ssl",
                         "models.csi.dual_band", "models.csi.strf",
                         "kernels.spectrogram", "runners.ssl",
                         "runners.dual_band", "cli.inspect_model",
                         "cli.ssl_inference", "utils.visualize",
                         "core.export", "cli.export_model",
                         "parallel.mesh", "parallel.collectives",
                         "parallel.partition", "parallel.pipeline",
                         "kernels.ring_attention", "entry"):
        assert f"multi_modal_csi_tpu_torch.{video_module}" in mods
    code = (
        "import importlib, sys\n"
        "for m in ('mesh', 'collectives', 'partition', 'pipeline'):\n"
        "    importlib.import_module('multi_modal_csi_tpu_torch.parallel.'"
        " + m)\n"
        "own = [m for m in sys.modules if m.startswith(\n"
        "       'multi_modal_csi_tpu_torch.') and not m.startswith(\n"
        "       'multi_modal_csi_tpu_torch.parallel')]\n"
        "assert not own, own\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'multi_modal_csi_tpu',\n"
        "        'tools', 'pandas', 'sklearn', 'cv2', 'msgpack',\n"
        "        'matplotlib')]\n"
        "print(len(bad), bad[:5])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("0 "), res.stdout
