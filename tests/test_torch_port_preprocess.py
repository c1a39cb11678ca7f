"""The port's CSI preprocessing (kernels/csi_preprocess.py, K5, and
cli/preprocess_csi.py) on the CPU, against the JAX package's.

K5's plain version against the JAX kernel ``amplitude_phase`` in interpret
mode:
- amplitude: bit for bit equal to the JAX formula sqrt(re*re + im*im)
  evaluated op by op (``amplitude_phase_reference`` outside jit), and
  within 1 ulp of the interpret-mode kernel, because XLA:CPU contracts
  re*re + im*im into one FMA there (measured: 8% of elements 1 ulp apart);
- phase: within 1e-6 absolute (atan2 of two libraries, |phase| <= pi).

The host path (``--device cpu``) is numpy's abs and angle, as in JAX, so
its files are bit for bit those of JAX ``extract_csi_amp`` on the same
synthetic traces. Traces reproduce the WiMANS .mat nesting (a (T, 1)
object cell of (1, 1) struct records whose LAST field is the (3, 3, 30)
complex64 CSI), as tests/test_preprocess.py writes them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as scio
import torch

from multi_modal_csi_tpu.cli import preprocess_csi as jax_pre
from multi_modal_csi_tpu.kernels.csi_preprocess import (
    amplitude_phase as jax_amplitude_phase,
    amplitude_phase_reference as jax_amplitude_phase_reference)
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.cli import preprocess_csi
from multi_modal_csi_tpu_torch.kernels import csi_preprocess
from multi_modal_csi_tpu_torch.kernels.csi_preprocess import (
    amplitude_phase, amplitude_phase_reference)

torch.set_num_threads(1)


def write_traces(dir_mat, n=2, packets=40, seed=11):
    """``n`` synthetic WiMANS traces of ``packets`` packets."""
    rng = np.random.default_rng(seed)
    rec_dt = np.dtype([("timestamp", "O"), ("csi", "O")])
    os.makedirs(dir_mat, exist_ok=True)
    for i in range(n):
        cell = np.empty((packets, 1), dtype=object)
        for t in range(packets):
            rec = np.empty((1, 1), dtype=rec_dt)
            csi = (rng.normal(size=(3, 3, 30))
                   + 1j * rng.normal(size=(3, 3, 30))).astype(np.complex64)
            rec[0, 0] = (np.float64(t), csi)
            cell[t, 0] = rec
        scio.savemat(os.path.join(dir_mat, f"act_{i}.mat"), {"trace": cell})


def parts(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 300, 270), (299, 270), (7, 5)])
def test_plain_version_matches_jax_kernel(shape):
    re, im = parts(shape)
    amp, phase = amplitude_phase(torch.from_numpy(re), torch.from_numpy(im))
    assert amp.shape == phase.shape == shape
    assert amp.dtype == phase.dtype == torch.float32
    j_amp, j_phase = jax_amplitude_phase(jnp.asarray(re), jnp.asarray(im),
                                         interpret=True)
    j_amp, j_phase = np.asarray(j_amp), np.asarray(j_phase)
    with jax.disable_jit():
        op_by_op = np.asarray(jax_amplitude_phase_reference(
            jnp.asarray(re), jnp.asarray(im))[0])
    assert np.array_equal(amp.numpy(), op_by_op)
    assert (np.abs(amp.numpy() - j_amp) <= np.spacing(j_amp)).all()
    np.testing.assert_allclose(phase.numpy(), j_phase, rtol=0, atol=1e-6)


def test_cpu_tensors_take_plain_version_without_counting():
    kernels.reset_launch_counts()
    re, im = (torch.from_numpy(a) for a in parts((30, 270), seed=1))
    got = amplitude_phase(re, im)
    want = amplitude_phase_reference(re, im)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kernels.LAUNCH_COUNTS.get(csi_preprocess.NAME, 0) == 0


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    re, im = (torch.from_numpy(a) for a in parts((30, 270), seed=2))
    if bad == "rank":
        re, im = re[0], im[0]
    elif bad == "shape":
        im = im[:29]
    elif bad == "dtype":
        re, im = re.double(), im.double()
    else:
        re = re.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        amplitude_phase(re, im)


def test_host_path_is_bit_exact_to_jax(tmp_path):
    """extract_csi_amp(device="cpu") against JAX's use_device=False, amp
    and phase files, and mat_trace_to_complex on one trace."""
    dir_mat = str(tmp_path / "mat")
    write_traces(dir_mat, n=2)
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    seconds = {}
    assert preprocess_csi.extract_csi_amp(
        dir_mat, str(mine / "amp"), str(mine / "phase"), device="cpu",
        seconds=seconds) == 2
    assert set(seconds) == {"parse", "save"}
    jax_pre.extract_csi_amp(dir_mat, str(theirs / "amp"),
                            str(theirs / "phase"), use_device=False)
    for sub in ("amp", "phase"):
        names = sorted(os.listdir(theirs / sub))
        assert names == sorted(os.listdir(mine / sub)) == ["act_0.npy",
                                                            "act_1.npy"]
        for name in names:
            a, b = np.load(mine / sub / name), np.load(theirs / sub / name)
            assert a.shape == (40, 3, 3, 30) and a.dtype == np.float32
            assert np.array_equal(a, b), (sub, name)
    m = scio.loadmat(os.path.join(dir_mat, "act_0.mat"))
    assert np.array_equal(preprocess_csi.mat_trace_to_complex(m),
                          jax_pre.mat_trace_to_complex(m))


def test_workers_pool_matches_serial(tmp_path):
    dir_mat = str(tmp_path / "mat")
    write_traces(dir_mat, n=3, packets=20, seed=12)
    d1, d2 = str(tmp_path / "w1"), str(tmp_path / "w2")
    assert preprocess_csi.extract_csi_amp(dir_mat, d1, device="cpu") == 3
    assert preprocess_csi.extract_csi_amp(dir_mat, d2, device="cpu",
                                          workers=2) == 3
    for f in sorted(os.listdir(d1)):
        assert np.array_equal(np.load(os.path.join(d1, f)),
                              np.load(os.path.join(d2, f)))
    with pytest.raises(ValueError, match="CPU only"):
        preprocess_csi.extract_csi_amp(dir_mat, d1, device="cuda",
                                       workers=2)


def test_card_path_without_card_raises(tmp_path, monkeypatch):
    """The default device is the card; without one it raises before any
    trace is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dir_mat = str(tmp_path / "mat")
    write_traces(dir_mat, n=1, packets=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess_csi.extract_csi_amp(dir_mat, str(tmp_path / "amp"))
    assert not os.path.exists(tmp_path / "amp")


def test_cli_on_cpu(tmp_path, capsys):
    dir_mat = str(tmp_path / "mat")
    write_traces(dir_mat, n=2, packets=10, seed=13)
    preprocess_csi.main(["--dir_mat", dir_mat,
                         "--dir_amp", str(tmp_path / "amp"),
                         "--dir_phase", str(tmp_path / "phase"),
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "converted 2 traces" in out and "parse" in out
    amp = np.load(tmp_path / "amp" / "act_1.npy")
    phase = np.load(tmp_path / "phase" / "act_1.npy")
    csi = preprocess_csi.mat_trace_to_complex(
        scio.loadmat(os.path.join(dir_mat, "act_1.mat")))
    assert np.array_equal(amp, np.abs(csi).astype(np.float32))
    assert np.array_equal(phase, np.angle(csi).astype(np.float32))
