"""The port's video data layer (multi_modal_csi_tpu_torch.data.video_io)
against the JAX package's ``data/video_io.py``: the transforms bit for bit
(torchvision's uint8 resize, center crop, normalize), and the clip cache
readers and the prefetching iterator in order, striding and errors."""

import dataclasses

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.data import video_io as jax_video_io
from multi_modal_csi_tpu_torch.data import video_io

torch.set_num_threads(1)


def test_transform_table_matches_jax():
    assert video_io.VIDEO_TRANSFORMS.keys() == \
        jax_video_io.VIDEO_TRANSFORMS.keys()
    for key, tf in video_io.VIDEO_TRANSFORMS.items():
        assert dataclasses.astuple(tf) == dataclasses.astuple(
            jax_video_io.VIDEO_TRANSFORMS[key]), key


@pytest.mark.parametrize("frame", [(240, 320), (320, 240), (256, 256)])
@pytest.mark.parametrize("key", ["MViT-v1", "MViT-v2", "ResNet"])
def test_apply_transform_matches_jax_bit_for_bit(key, frame):
    frames = np.random.default_rng(7).integers(
        0, 256, (3, *frame, 3), dtype=np.uint8)
    want = jax_video_io.apply_transform(
        frames, jax_video_io.VIDEO_TRANSFORMS[key], backend="torch")
    got = video_io.apply_transform(frames, video_io.VIDEO_TRANSFORMS[key])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def cache(tmp_path):
    """Five cached clips of different content, 6 frames each."""
    rng = np.random.default_rng(3)
    labels = [f"clip_{i}" for i in range(5)]
    for label in labels:
        np.save(tmp_path / f"{label}.npy",
                rng.standard_normal((6, 4, 5, 3)).astype(np.float32))
    y = np.eye(5, dtype=np.float32)
    return str(tmp_path), labels, y


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_clip_readers_match_jax(cache, stride):
    root, labels, y = cache
    order = labels[::-1]
    np.testing.assert_array_equal(
        video_io.load_clips(root, order, stride, num_threads=2),
        jax_video_io.load_clips(root, order, stride, num_threads=2))
    port = video_io.ClipDataset(root, labels, y, stride)
    ref = jax_video_io.ClipDataset(root, labels, y, stride)
    assert len(port) == len(ref) == 5
    np.testing.assert_array_equal(port.example(), ref.example())
    for a, b in zip(port.batch([3, 0, 4]), ref.batch([3, 0, 4])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("workers,prefetch", [(1, 1), (3, 2), (4, 4)])
def test_prefetch_batches_order_matches_jax(cache, workers, prefetch):
    root, labels, y = cache
    rows = [np.array([4, 1]), np.array([0, 2]), np.array([3]),
            np.array([1, 1])]
    for dataset in (video_io.ClipDataset(root, labels, y, 2),
                    video_io.ArrayClips(
                        np.arange(5 * 8, dtype=np.float32).reshape(5, 8), y)):
        got = list(video_io.prefetch_batches(dataset, rows, workers,
                                             prefetch))
        want = list(jax_video_io.prefetch_batches(dataset, rows, workers,
                                                  prefetch))
        assert len(got) == len(want) == len(rows)
        for (gx, gy), (wx, wy), row in zip(got, want, rows):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, y[row])


def test_prefetch_batches_reraises_a_workers_error(cache):
    """A missing clip in the third batch: the first two arrive, then the
    worker's FileNotFoundError is raised, in both packages."""
    root, labels, y = cache
    rows = [np.array([0]), np.array([1]), np.array([2]), np.array([3])]
    for module in (video_io, jax_video_io):
        dataset = module.ClipDataset(root, labels[:2] + ["missing"]
                                     + labels[3:], y)
        got = []
        with pytest.raises(FileNotFoundError):
            for batch in module.prefetch_batches(dataset, rows, 2, 1):
                got.append(batch)
        assert len(got) == 2
