"""The port's initial weights of the convs that JAX builds with flax's
default ``nn.Conv`` (lecun-normal kernel, zero bias), against JAX's own
draws, and the f32 convolutions' TF32 flag.

Init: MViT's depthwise pooling convs (JAX ``models/video/mvit.py:178``,
initialised through JAX's ``PoolConv``), MViT's ``conv_proj`` (``:361``)
and Swin3D's ``patch_embed`` (``models/video/swin3d.py:264``), both inline
``nn.Conv`` calls of the whole models, whose JAX ``init`` takes 25-35 s on
the CPU even at a (4, 32, 32) clip; those two are drawn by flax's ``nn.Conv``
with the arguments JAX's models give it. Over two seeds of each package,
the sample standard deviations agree within 10% (the sampling error of the
smallest sample, Swin's 9,216 values, is under 1%), each sample's mean
lies within 5 standard errors of zero, and every bias is exactly zero.

TF32: ``F.conv1d``, ``F.conv2d``, ``F.conv3d`` and ``torch.lstm`` are
wrapped with a recorder that reads cuDNN's TF32 flag at call time, the flag
is set to PyTorch's default (on), and each conv layer and the LSTM run
forward in f32: every call must see the flag off, and the flag must read
on again afterwards. A training step's convolutions, forward and
backward, are recorded at the ATen level the same way.
"""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from multi_modal_csi_tpu.models.video.mvit import PoolConv as JaxPoolConv
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.nn import layers as L
from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS
from multi_modal_csi_tpu_torch.runners.video import build_video_model
from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                  make_train_step)

torch.set_num_threads(1)

SEEDS = (0, 1)
CLIP = (8, 64, 64)
STD_RTOL = 0.1
MEAN_ERRORS = 5.0


def _jax_conv(features, kernel, strides, pads, in_ch, seed):
    """flax's default ``nn.Conv`` draw at the arguments of JAX's model."""
    conv = fnn.Conv(features, kernel, strides=strides, padding=pads)
    x = np.zeros((1, 8, 16, 16, in_ch), np.float32)
    p = conv.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    return np.asarray(p["kernel"]), np.asarray(p["bias"])


def _jax_pool(seed):
    """The kernel of JAX's MViT pooling conv (96 heads' worth of d = 96)."""
    pool = JaxPoolConv(96, (3, 3, 3), (1, 2, 2))
    x = np.zeros((1, 1, 1 + 4 * 8 * 8, 96), np.float32)
    p = pool.init({"params": jax.random.PRNGKey(seed)}, x, (4, 8, 8))
    return np.asarray(p["params"]["conv"]["kernel"])


def _jax_draws(name, seed):
    if name == "mvit.pool":
        return _jax_pool(seed), None
    if name == "mvit.conv_proj":
        return _jax_conv(96, (3, 7, 7), (2, 4, 4), [(1, 1), (3, 3), (3, 3)],
                         3, seed)
    return _jax_conv(96, (2, 4, 4), (2, 4, 4), "VALID", 3, seed)


def _port_draws(name, seed):
    if name.startswith("mvit"):
        model = build_video_model("MViT-v2", 6, CLIP, seed=seed).backbone
        if name == "mvit.pool":
            conv = model.blocks[1].attn.pool_k.pool
        else:
            conv = model.conv_proj
    else:
        conv = build_video_model("Swin-T", 6, CLIP,
                                 seed=seed).backbone.patch_embed.proj
    bias = None if conv.bias is None else conv.bias.detach().numpy()
    return conv.weight.detach().numpy(), bias


def _assert_centred(w):
    assert abs(w.mean()) <= MEAN_ERRORS * w.std() / np.sqrt(w.size)


@pytest.mark.parametrize("name", ["mvit.pool", "mvit.conv_proj",
                                  "swin.patch_embed"])
def test_flax_default_conv_init(name):
    port, ref = [], []
    for seed in SEEDS:
        w, b = _port_draws(name, seed)
        jw, jb = _jax_draws(name, seed)
        assert w.size == jw.size
        for drawn in (w, jw):
            _assert_centred(drawn)
        if jb is not None:
            assert b is not None and not b.any() and not jb.any()
        else:
            assert b is None
        port.append(w.ravel())
        ref.append(jw.ravel())
    std, want = np.concatenate(port).std(), np.concatenate(ref).std()
    assert abs(std / want - 1) <= STD_RTOL, (std, want)


@pytest.fixture
def cudnn_calls(monkeypatch):
    """cuDNN's TF32 flag as each F.conv{1,2,3}d and torch.lstm call saw
    it, with the flag at PyTorch's default (on) beforehand."""
    seen = []
    for owner, name in ((F, "conv1d"), (F, "conv2d"), (F, "conv3d"),
                        (torch, "lstm")):
        real = getattr(owner, name)

        def recorder(*args, _real=real, _name=name, **kw):
            seen.append((_name, torch.backends.cudnn.allow_tf32))
            return _real(*args, **kw)
        monkeypatch.setattr(owner, name, recorder)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    return seen


def test_f32_convs_and_lstm_run_with_tf32_off(cudnn_calls):
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        L.Conv1d(6, 8, 5, padding="SAME", generator=g)(torch.randn(2, 20, 6))
        L.Conv2d(3, 4, (3, 3), generator=g)(torch.randn(2, 9, 9, 3))
        L.Conv3d(3, 4, (3, 3, 3), padding=(1, 1, 1), generator=g)(
            torch.randn(1, 4, 6, 6, 3))
        L.Conv3d(4, 4, (3, 3, 3), groups=4, bias=False, generator=g)(
            torch.randn(1, 4, 6, 6, 4))
        L.LSTM(6, 8, bidirectional=True, generator=g)(torch.randn(2, 5, 6))
    assert [name for name, _ in cudnn_calls] == [
        "conv1d", "conv2d", "conv3d", "conv3d", "lstm"]
    assert not any(tf32 for _, tf32 in cudnn_calls), cudnn_calls
    assert torch.backends.cudnn.allow_tf32


def test_f32_convs_of_models_run_with_tf32_off(cudnn_calls):
    """Every convolution of a video model's f32 forward (Swin's patch
    embed) and a CSI model's (CNN-1D) sees the flag off."""
    with torch.no_grad():
        build_video_model("Swin-T", 6, (4, 32, 32))(
            torch.randn(1, 4, 32, 32, 3))
        cnn = CSI_MODELS["CNN-1D"].build((393, 20), 54, Config(),
                                         torch.Generator().manual_seed(0))
        cnn.eval()(torch.randn(2, 393, 20))
    assert len(cudnn_calls) >= 4
    assert not any(tf32 for _, tf32 in cudnn_calls), cudnn_calls


class _AtenFlags(TorchDispatchMode):
    """cuDNN's TF32 flag as each convolution op saw it, forward and
    backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith("convolution"):
            self.seen.append((func.__name__,
                              torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_training_step_convs_run_with_tf32_off(monkeypatch):
    """A CNN-1D training step (``train/loop.py::make_train_step``): the
    convolutions' forward and backward ops see the flag off."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = CSI_MODELS["CNN-1D"].build((393, 20), 54, Config(),
                                       torch.Generator().manual_seed(0))
    step = make_train_step(model, adam_like_torch(model.parameters(), 1e-3),
                           lambda o, t: ((o - t) ** 2).mean(), augment=False)
    with _AtenFlags() as mode:
        step(torch.randn(2, 393, 20), torch.zeros(2, 54),
             torch.Generator().manual_seed(0))
    names = [name for name, _ in mode.seen]
    assert "convolution_backward.default" in names, names
    assert not any(tf32 for _, tf32 in mode.seen), mode.seen
    assert torch.backends.cudnn.allow_tf32
