"""The port's Swin3D (models/video/swin3d.py) against the JAX package's on
the CPU, with test_torch_port_video_backbones.py's helpers and tolerances:
"Swin-T" and "Swin-S" narrowed (``embed_dim`` 8, window (2, 3, 3), depths
(2, 2) and (2, 2, 2)) on (2, 5, 36, 8, 3) clips for the forwards, the
training step and bf16 serving; ``load_video_pretrained`` of both at their
published depths (narrowed in width); and the shifted-window tables.
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.models.video import swin3d as jax_swin
from multi_modal_csi_tpu_torch.models.video import swin3d as S
from test_torch_port_video_backbones import (Pair, check_bf16,
                                             check_forward, check_pretrained,
                                             check_step)

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["Swin-T", "Swin-S"])
def pair(request):
    return Pair(request.param)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(pair, mode):
    check_forward(pair, mode)


def test_train_step_matches_jax(pair):
    check_step(pair)


def test_bf16_serving_matches_jax(pair):
    check_bf16(pair)


@pytest.mark.parametrize("key", ["Swin-T", "Swin-S"])
def test_load_video_pretrained_matches_jax(key, tmp_path):
    check_pretrained(key, tmp_path)


def test_swin_layout_helpers():
    """The port's shifted-window tables against the JAX package's: the
    region ids, the relative position index, and window_partition /
    window_reverse as inverse reshapes of JAX's."""
    for dims, window, shift in (((4, 6, 6), (2, 3, 3), (1, 1, 1)),
                                ((4, 14, 14), (2, 7, 7), (0, 3, 3)),
                                ((8, 7, 14), (8, 7, 7), (4, 0, 3))):
        np.testing.assert_array_equal(
            S._shift_window_ids(dims, window, shift),
            jax_swin._shift_window_ids(dims, window, shift))
        np.testing.assert_array_equal(S._relative_position_index(window),
                                      jax_swin._relative_position_index(
                                          window))
        x = np.random.default_rng(0).standard_normal((2, *dims, 3)).astype(
            np.float32)
        w = S.window_partition(torch.from_numpy(x), window)
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(jax_swin.window_partition(x, window)))
        np.testing.assert_array_equal(
            S.window_reverse(w, window, 2, *dims).numpy(), x)
