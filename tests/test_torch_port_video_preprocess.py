"""The port's video decoding and preprocessing (data/video_io.py,
cli/preprocess_video.py) against the JAX package's on the CPU, on .mp4
clips written here with ``cv2.VideoWriter`` (mp4v, 48 x 64 frames of
seeded colour gradients that move frame to frame).

- ``decode_video``: the same uint8 RGB frames as JAX's, bit for bit;
- ``preprocess_video_dir`` in both resize backends (torch: torchvision's
  resize; cv2) and for a fixed-size (ResNet) and a short-side (Swin-T)
  transform: the same cached float32 clips as JAX's, bit for bit, and
  the same labels reported for a frame count other than 90;
- ``check_video_integrity``: a short clip and a missing one flagged, as
  JAX flags them;
- ``cli/preprocess_video.py`` on the CPU: the cache written, the short
  clip reported, ``--check`` alone.
"""

import csv
import os

import cv2
import numpy as np
import pytest

from multi_modal_csi_tpu.data import video_io as jax_io
from multi_modal_csi_tpu_torch.cli import preprocess_video
from multi_modal_csi_tpu_torch.data import video_io

SIZE = (48, 64)                 # H, W
CLIPS = {"act_0": 90, "act_1": 90, "short": 8}


def write_clip(path, n, seed):
    rng = np.random.default_rng(seed)
    h, w = SIZE
    base = (np.add.outer(np.arange(h), np.arange(w)) * 2).astype(np.int64)
    offsets = rng.integers(0, 255, 3)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15,
                             (w, h))
    assert writer.isOpened(), "cv2 has no mp4v encoder"
    for i in range(n):
        frame = np.stack([(base + 5 * i + o) % 256 for o in offsets], -1)
        writer.write(frame.astype(np.uint8))
    writer.release()


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    for seed, (label, n) in enumerate(CLIPS.items()):
        write_clip(str(root / f"{label}.mp4"), n, seed)
    return str(root)


def test_decode_video_matches_jax(video_dir):
    for label, n in CLIPS.items():
        path = os.path.join(video_dir, f"{label}.mp4")
        got = video_io.decode_video(path)
        assert got.shape == (n, *SIZE, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_io.decode_video(path))
    with pytest.raises(IOError, match="could not decode"):
        video_io.decode_video(os.path.join(video_dir, "missing.mp4"))


@pytest.mark.parametrize("backend", ["torch", "cv2"])
@pytest.mark.parametrize("model", ["ResNet", "Swin-T"])
def test_preprocess_video_dir_matches_jax(video_dir, tmp_path, backend,
                                          model):
    labels = list(CLIPS)
    got_bad = video_io.preprocess_video_dir(
        video_dir, labels, model, str(tmp_path / "port"), num_threads=2,
        backend=backend)
    want_bad = jax_io.preprocess_video_dir(
        video_dir, labels, model, str(tmp_path / "jax"), num_threads=2,
        backend=backend)
    assert sorted(got_bad) == sorted(want_bad) == ["short"]
    crop = video_io.VIDEO_TRANSFORMS[model].crop
    for label, n in CLIPS.items():
        got = np.load(tmp_path / "port" / f"{label}.npy")
        assert got.shape == (n, *crop, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, np.load(tmp_path / "jax" / f"{label}.npy"))


def test_check_video_integrity_matches_jax(video_dir):
    labels = list(CLIPS) + ["missing"]
    got = video_io.check_video_integrity(video_dir, labels)
    assert got == ["short", "missing"]
    assert got == jax_io.check_video_integrity(video_dir, labels)


def write_annotation(path, labels):
    header = ["label", "environment", "wifi_band", "number_of_users"] + [
        f"user_{u}_{what}" for u in range(1, 7)
        for what in ("location", "activity")]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for label in labels:
            writer.writerow([label, "classroom", "5", "1", "a", "walk"]
                            + [""] * 10)


def test_preprocess_video_cli_on_cpu(video_dir, tmp_path, capsys):
    annotation = str(tmp_path / "annotation.csv")
    write_annotation(annotation, list(CLIPS))
    cache = tmp_path / "cache"
    preprocess_video.main(["--model", "ResNet", "--path_data_x", video_dir,
                           "--path_data_y", annotation, "--path_data_pre_x",
                           str(cache), "--threads", "2"])
    out = capsys.readouterr().out
    assert "short Warning!" in out and "Preprocess Time:" in out
    assert sorted(os.listdir(cache)) == sorted(f"{label}.npy"
                                               for label in CLIPS)
    assert np.load(cache / "act_0.npy").shape == (90, 112, 112, 3)
    preprocess_video.main(["--check", "--path_data_x", video_dir,
                           "--path_data_y", annotation])
    out = capsys.readouterr().out
    assert "short Warning!" in out and "act_0 Warning!" not in out
