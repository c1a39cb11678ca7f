"""The port's export CLI (cli/export_model.py) on the CPU, as the JAX
package's tests/test_export.py:159-198 run its own: DETR and ResNet3D-18
exported in a subprocess for the CPU, each artifact served with
``serve_file``; and the CLI's keys and refusals against JAX's CLI.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.cli import export_model as jax_cli
from multi_modal_csi_tpu.runners.csi import CSI_MODELS as JAX_CSI_MODELS
from multi_modal_csi_tpu.runners.video import VIDEO_MODELS as JAX_VIDEO
from multi_modal_csi_tpu_torch.cli import export_model as cli
from multi_modal_csi_tpu_torch.core.export import serve_file
from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS
from multi_modal_csi_tpu_torch.runners.video import VIDEO_MODELS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _export(args):
    res = subprocess.run(
        [sys.executable, "-m", "multi_modal_csi_tpu_torch.cli.export_model",
         *args, "--platforms", "cpu", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def test_export_cli_detr(tmp_path):
    out = str(tmp_path / "detr.mmcsi")
    printed = _export(["--model", "DETR", "--task", "activity", "--batch",
                       "2", "--out", out, "--dtype", "float32"])
    assert "the weights it serves" in printed
    fn, meta = serve_file(out, "cpu")
    assert meta["model"] == "DETR" and meta["serving_dtype"] == "float32"
    assert meta["input_shape"] == [2, 3000, 270]
    logits = fn(np.zeros(meta["input_shape"], np.float32))
    # DETR serving output: (L, B, Q, 10), per decoder layer
    assert tuple(logits.shape)[1:] == (2, 5, 10)
    assert bool(torch.isfinite(logits).all())


def test_export_cli_video_resnet3d(tmp_path):
    out = str(tmp_path / "r3d.mmcsi")
    _export(["--model", "ResNet", "--batch", "1", "--out", out, "--dtype",
             "float32", "--clip-shape", "8,64,64"])
    fn, meta = serve_file(out, "cpu")
    assert meta["model"] == "ResNet"
    assert meta["input_shape"] == [1, 8, 64, 64, 3]
    logits = fn(np.zeros((1, 8, 64, 64, 3), np.float32))
    assert tuple(logits.shape) == (1, 54) and bool(torch.isfinite(
        logits).all())


def test_cli_takes_every_key_of_jax_cli():
    """JAX's CLI takes its CSI table's and its video table's keys (SSL,
    dual band and ST-RF have runners of their own there too); so does the
    port's, with JAX's task dims and out dims."""
    assert set(CSI_MODELS) == set(JAX_CSI_MODELS)
    assert set(VIDEO_MODELS) == set(JAX_VIDEO)
    assert cli._TASK_DIMS == jax_cli._TASK_DIMS
    for key in CSI_MODELS:
        for task in cli._TASK_DIMS:
            try:
                want = jax_cli.infer_out_dim(key, task)
            except SystemExit as refused:
                with pytest.raises(SystemExit, match=str(refused)):
                    cli.infer_out_dim(key, task)
            else:
                assert cli.infer_out_dim(key, task) == want


@pytest.mark.parametrize("argv,match", [
    (["--model", "SSL"], "unknown model SSL"),
    (["--model", "THAT_MULTI_HEAD", "--task", "identity"],
     "supports task=activity only"),
    (["--model", "THAT", "--quant", "w8a8"], "pass --calib"),
    (["--model", "DETR", "--quant", "auto"], "resolved to w8a8"),
    (["--model", "THAT", "--input-dtype", "int8"], "--input-scale or"),
])
def test_cli_refuses_what_jax_refuses(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main([*argv, "--out", str(tmp_path / "x.mmcsi"), "--batch", "2",
                  "--device", "cpu"])
