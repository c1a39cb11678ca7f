"""The port's video serving half (runners/video.py, core/serving.py::
VideoServer, cli/serve_video.py) on the CPU, against the JAX package's
``runners/video.py`` where it has a counterpart.

The models are full width at small clips: (4, 32, 32) and (4, 64, 64)
keep the JAX side fast (below the K3 gate, so both take their eager
attention; tests/test_torch_port_mvit.py holds the K3 path). Tolerances:
f32 logits 1e-4 (absolute and relative); predictions and accuracy equal;
bf16 logits within 2% of the largest f32 logit.
"""

import copy
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.data.video_io import ArrayClips as JaxArrayClips
from multi_modal_csi_tpu.models.video import mvit as jax_mvit
from multi_modal_csi_tpu.runners import video as jax_video
from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu.train.loop import make_eval_fn
from multi_modal_csi_tpu_torch.cli import serve_video
from multi_modal_csi_tpu_torch.core.config import (Config,
                                                   resolve_serving_batch,
                                                   resolve_serving_dtype)
from multi_modal_csi_tpu_torch.core.serving import VideoServer
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.data.video_io import ArrayClips
from multi_modal_csi_tpu_torch.runners import video
from multi_modal_csi_tpu_torch.train.loop import cast_for_serving
from tools.convert_torchvision import convert_mvit

torch.set_num_threads(1)

CLIP = (4, 32, 32)
OUT = 6
TOL = 1e-4


def clips(n, clip=CLIP, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, *clip, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def v2_pair():
    """A JAX MViT-v2 (model, variables) and the port model with the same
    weights, at CLIP: the port's seeded weights read into the JAX tree by
    the JAX package's own converter (no JAX init, which is slow here)."""
    port = video.build_video_model("MViT-v2", OUT, CLIP, seed=4)
    params, _ = convert_mvit(port.backbone.state_dict(), OUT, "v2")
    params["head"] = {"kernel": port.task_head.weight.detach().numpy().T,
                      "bias": port.task_head.bias.detach().numpy()}
    variables = {"params": params}
    reloaded = video.build_video_model("MViT-v2", OUT, CLIP)
    reloaded.load_state_dict(state_dict_from_jax("MViT-v2", variables),
                             strict=True)
    return jax_mvit.MViT(OUT, variant="v2"), variables, reloaded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evaluate_matches_jax_evaluate(v2_pair, dtype):
    """5 clips in chunks of 2: the tail chunk is padded with a zero clip
    and its logits cut, on both sides."""
    jmodel, variables, port = v2_pair
    x = clips(5, seed=1)
    y = np.random.default_rng(2).integers(0, 2, (5, OUT)).astype(np.float32)
    params = variables["params"]
    jdt = tdt = None
    if dtype == "bfloat16":
        f32 = video.evaluate(port, ArrayClips(x, y), 0.5)[2]
        jdt, tdt = jnp.bfloat16, torch.bfloat16
        params = jax_cast(params, jdt)
        port = cast_for_serving(copy.deepcopy(port), tdt)
    want = jax_video._evaluate(make_eval_fn(jmodel), params, {},
                               JaxArrayClips(x, y), 0.5, chunk=2,
                               num_workers=2, dtype=jdt)
    acc, pred, logits = video.evaluate(port, ArrayClips(x, y), 0.5, chunk=2,
                                       num_workers=2, dtype=tdt)
    assert logits.shape == (5, OUT) and logits.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(logits, want[2], atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(pred, want[1])
        assert acc == want[0]
    else:
        assert np.abs(logits - want[2]).max() <= 0.02 * np.abs(f32).max()


@pytest.mark.parametrize("n", [1, 3])
def test_ragged_requests_match_unbatched_forward(v2_pair, n):
    _, _, port = v2_pair
    x = clips(n, seed=n)
    with torch.no_grad():
        want = torch.cat([port(torch.from_numpy(x[i:i + 1]))
                          for i in range(n)]).numpy()
    server = VideoServer("MViT-v2", port, dtype="float32", device="cpu")
    assert server.batch == 2
    got = server(x)
    assert got.dtype == torch.float32 and got.shape == (n, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_load_video_pretrained_matches_jax(tmp_path):
    """A torchvision-layout MViT-v2 .pt made at (4, 32, 32) loaded for
    (4, 64, 64) clips: the relative tables resized, a fresh task head.
    (v1's tables are redrawn, not read: test_torch_port_mvit.py holds that
    step against the JAX package's. At clips where a pooled size is odd
    the JAX package's resize sizes the last stage's tables with a floor
    that its model does not use, and refuses them; the port keeps that
    rule.)"""
    key, variant = "MViT-v2", "v2"
    path = str(tmp_path / "mvit.pt")
    torch.save(video.build_video_model(key, 400, CLIP, seed=5)
               .backbone.state_dict(), path)
    clip = (4, 64, 64)
    x = clips(2, clip, seed=6)
    jmodel = jax_mvit.MViT(OUT, variant=variant)
    v0 = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x[:1]), train=False))
    params, stats = jax_video.load_video_pretrained(path, key, OUT, v0,
                                                    x[:1].shape)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   train=False))

    model = video.load_video_pretrained(
        path, key, video.build_video_model(key, OUT, clip, seed=9))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_load_video_pretrained_checks_shapes(tmp_path):
    path = str(tmp_path / "v1.pt")
    torch.save(video.build_video_model("MViT-v1", 400, CLIP)
               .backbone.state_dict(), path)
    with pytest.raises(ValueError, match="does not match"):
        video.load_video_pretrained(
            path, "MViT-v2", video.build_video_model("MViT-v2", OUT, CLIP))


# a small clip each of the four backbones runs at (S3D's pools need 8
# frames of at least 32 x 32)
SMALL_CLIPS = {"ResNet": (4, 32, 32), "S3D": (8, 32, 32),
               "Swin-T": (4, 32, 32), "Swin-S": (4, 32, 32)}


@pytest.mark.parametrize("key", ["ResNet", "S3D", "Swin-T", "Swin-S",
                                 "unknown"])
def test_unported_video_models_raise(key):
    """Each of ResNet, S3D, Swin-T and Swin-S builds at full width for a
    small clip and serves a ragged request of 3 clips on the CPU at batch
    2, as its forward on each clip alone; an unknown key raises KeyError
    in both the builder and the server. (The name is kept from the tree
    where the four keys raised.)"""
    if key == "unknown":
        with pytest.raises(KeyError, match="unknown video model"):
            video.build_video_model(key, OUT)
        with pytest.raises(KeyError, match="unknown video model"):
            VideoServer(key, torch.nn.Identity(), device="cpu")
        return
    clip = SMALL_CLIPS[key]
    model = video.build_video_model(key, OUT, clip, seed=3)
    assert model.backbone.clip == clip
    x = clips(3, clip, seed=4)
    with torch.no_grad():
        want = torch.cat([model(torch.from_numpy(x[i:i + 1]))
                          for i in range(3)]).numpy()
    server = VideoServer(key, model, dtype="float32", device="cpu", batch=2)
    got = server(x)
    assert got.dtype == torch.float32 and got.shape == (3, OUT)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_serving_defaults_match_jax():
    from multi_modal_csi_tpu.core.config import (
        resolve_serving_batch as jax_batch, resolve_serving_dtype as jax_dtype)
    for key in ("MViT-v1", "MViT-v2", "ResNet", "S3D", "Swin-T", "Swin-S",
                "THAT", "DETR"):
        assert resolve_serving_dtype("auto", key) == jax_dtype("auto", key)
        assert resolve_serving_batch(key) == jax_batch(key)
    assert resolve_serving_dtype("auto", "MViT-v2") == "bfloat16"
    assert resolve_serving_batch("MViT-v1") == 2


def test_video_server_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoServer("MViT-v1", video.build_video_model("MViT-v1", OUT, CLIP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_video.main(["--model", "MViT-v1", "--clip", "4,32,32"])


def test_serve_video_cli_on_cpu(capsys):
    serve_video.main(["--model", "MViT-v2", "--device", "cpu", "--clip",
                      "4,32,32", "--requests", "3,1"])
    out = capsys.readouterr().out
    assert "request of 3 clips -> logits (3, 6)" in out
    assert "clips/s" in out


def test_load_video_data_matches_jax(tmp_path):
    """The annotation filter, the seed-39 split and the label encoding give
    JAX's clip labels and targets in JAX's order."""
    rng = np.random.default_rng(8)
    header = ["label", "environment", "wifi_band", "number_of_users"] + [
        f"user_{u}_{what}" for u in range(1, 7)
        for what in ("location", "activity")]
    with open(tmp_path / "annotation.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for i in range(23):
            users = int(rng.integers(0, 4))
            row = [f"act_{i}", ["classroom", "empty_room"][i % 2], "5",
                   str(users)]
            for u in range(6):
                row += ([str(rng.choice(list("abcde"))), "walk"]
                        if u < users else ["", ""])
            writer.writerow(row)
    overrides = {"path.data_y": str(tmp_path / "annotation.csv"),
                 "path.video_pre_x": str(tmp_path), "task": "location",
                 "data.environment": ["classroom"], "data.frame_stride": 2}
    port = video.load_video_data(Config().override(overrides))
    ref = jax_video.load_video_data(JaxConfig().override(overrides))
    for got, want in zip(port, ref):
        assert got.labels == want.labels and got.stride == want.stride == 2
        np.testing.assert_array_equal(got.y, want.y)
        assert got.y.shape[1] == 30
