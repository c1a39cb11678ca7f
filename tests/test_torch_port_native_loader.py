"""The port's C++ window loader (data/native_loader.py, its own copy of the
source under data/csrc/) against the JAX package's native loader and the
port's numpy loader, on ``tests/test_native_loader.py``'s ragged sample:
bit for bit at 1 and 8 threads, with windows longer and shorter than
``length``; a missing file raises IOError; without a compiler the loader
says so once and reads with numpy; ``master_split`` reads through it.
"""

import numpy as np
import pytest

from multi_modal_csi_tpu.data.native_loader import (
    load_csi_windows_native as jax_native)
from multi_modal_csi_tpu_torch.data import native_loader
from multi_modal_csi_tpu_torch.data.csi_io import load_csi_windows
from multi_modal_csi_tpu_torch.data.native_loader import (
    load_csi_windows_native, native_available)
from multi_modal_csi_tpu_torch.kernels import build
from multi_modal_csi_tpu_torch.runners import csi as runner

LABELS = ["s0", "s1", "s2", "s3"]


@pytest.fixture(scope="module")
def sample_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("amp")
    rng = np.random.default_rng(0)
    for i, t in enumerate([5, 12, 20, 1]):
        np.save(d / f"s{i}.npy",
                rng.normal(size=(t, 3, 3, 30)).astype(np.float32))
    return str(d)


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("length", [12, 16])
def test_native_matches_jax_and_numpy(sample_dir, threads, length):
    assert native_available()
    library = build.hashed_target("csi_loader", [native_loader.SOURCE],
                                  native_loader.GXX_FLAGS)
    assert library.exists() and library.parent == build.BUILD_DIR
    got = load_csi_windows_native(sample_dir, LABELS, length=length,
                                  num_threads=threads)
    want = jax_native(sample_dir, LABELS, length=length,
                      num_threads=threads)
    plain = load_csi_windows(sample_dir, LABELS, length, threads)
    assert got.dtype == want.dtype == plain.dtype == np.float32
    assert got.shape == want.shape == plain.shape == (4, length, 3, 3, 30)
    assert np.array_equal(got, want) and np.array_equal(got, plain)
    # s2's 20 steps keep their last `length`; s3's one step is left-padded
    assert not got[3, :-1].any() and got[3, -1].any()
    assert load_csi_windows_native(sample_dir, [], length=length).shape == (
        0, length, 3, 3, 30)


def test_native_missing_file_raises(sample_dir):
    with pytest.raises(IOError, match="1/2 files"):
        load_csi_windows_native(sample_dir, ["s0", "nope"], length=8)


def test_without_a_compiler_reads_with_numpy(sample_dir, tmp_path,
                                             monkeypatch, capsys):
    """No library and no g++: one stderr line, then the numpy loader."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    got = load_csi_windows_native(sample_dir, LABELS, length=12)
    again = load_csi_windows_native(sample_dir, LABELS, length=12)
    assert not native_available()
    err = capsys.readouterr().err
    assert err.count("[native_loader]") == 1 and "g++ not found" in err
    want = load_csi_windows(sample_dir, LABELS, 12)
    assert np.array_equal(got, want) and np.array_equal(again, want)
    assert not (tmp_path / "_build").exists()


def test_master_split_reads_through_the_native_loader(monkeypatch):
    calls = []

    def recording(*args, **kwargs):
        calls.append(args)
        raise StopIteration

    monkeypatch.setattr(runner, "load_csi_windows_native", recording)
    monkeypatch.setattr(runner, "load_annotation", lambda path: None)
    monkeypatch.setattr(runner, "filter_annotation", lambda *a, **k: None)
    monkeypatch.setattr(runner, "label_list", lambda df: ["a"])
    with pytest.raises(StopIteration):
        runner.master_split(runner.Config())
    assert calls and calls[0][1] == ["a"]
