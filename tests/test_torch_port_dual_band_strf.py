"""The port's dual-band model and runner (models/csi/dual_band.py,
runners/dual_band.py) and ST-RF (models/csi/strf.py,
kernels/spectrogram.py, the runner's ``_run_strf``) against the JAX
package's, on the CPU.

- DualBandCNN's forward at (393, 30) windows per band (the fewest steps
  CNN-1D's stages take) within 1e-5, with different data in each band, so
  a model that fed one band to the other tower would fail (the swapped
  input is checked to give other logits).
- ``load_dual_band_data`` on a synthetic dataset of two bands: the arrays
  equal to JAX's.
- ``run_dual_band`` against JAX's with nn.epoch 0 from JAX's initial
  weights of repeat 0 (the result dicts' reports equal).
- ST-RF: ``spectrogram_features`` bit for bit against JAX's (both
  scipy); ``strf_features`` (torch) against JAX's scipy and jnp pipelines
  within 1e-5 of each feature; the runner's chunked ``device_features``
  equal to one pass; the ST-RF result dict (the port's forest on the
  torch features, JAX's on scipy's) equal to JAX's, and an ImportError
  that names sklearn where sklearn is missing.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.kernels import spectrogram as jax_spectrogram
from multi_modal_csi_tpu.models.csi import strf as jax_strf
from multi_modal_csi_tpu.models.csi.dual_band import DualBandCNN as JaxDual
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu.runners import dual_band as jax_dual
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.kernels import spectrogram
from multi_modal_csi_tpu_torch.models.csi import strf
from multi_modal_csi_tpu_torch.models.csi.dual_band import DualBandCNN
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.runners import dual_band
from test_torch_port_checkpoint import (skip_step_compile,
                                        write_narrow_dataset)
from test_torch_port_layers import gen
from test_torch_port_runner import perturbed
from test_torch_port_ssl import labels

torch.set_num_threads(1)

SHAPE, OUT = (393, 30), 54


def paired(n, seed):
    """(n, 2, T, C) windows whose bands differ in scale and offset."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2) + SHAPE, dtype=np.float32)
    x[:, 1] = 3.0 * x[:, 1] + 1.0
    return x


def test_forward_matches_jax():
    port = perturbed(DualBandCNN(OUT, channels=SHAPE[1], generator=gen(1)),
                     1).eval()
    x = paired(3, seed=2)
    shapes = jax.eval_shape(lambda: JaxDual(OUT).init(
        {"params": jax.random.PRNGKey(0)}, x[:1], train=False))
    state = {k: v.clone() for k, v in port.state_dict().items()}
    variables = import_state_dict("dual_band", state, shapes)
    assert set(state_dict_from_jax("dual_band", variables)) == set(state)
    want = np.asarray(JaxDual(OUT).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), x))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        swapped = port(torch.from_numpy(x[:, ::-1].copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(swapped - want).max() > 1e-2


def test_load_dual_band_data_matches_jax(tmp_path):
    overrides = dict(write_narrow_dataset(tmp_path, n=40, seed=3),
                     **{"data.wifi_band": ["2.4"],
                        "data_band2.wifi_band": ["5"],
                        "data_band2.environment": ["classroom",
                                                   "meeting_room",
                                                   "empty_room"],
                        "data_band2.length": 300})
    got = dual_band.load_dual_band_data(Config().override(overrides))
    want = jax_dual.load_dual_band_data(JaxConfig().override(overrides))
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert got[0].shape[1:] == (2, 300, 30)
    assert not np.array_equal(got[0][:, 0], got[0][:, 1])


@pytest.mark.filterwarnings("ignore:AOT train-step lowering failed")
def test_run_dual_band_matches_jax(monkeypatch):
    x = paired(14, seed=4)
    y = labels(14, seed=5)
    data = (x[:8], x[8:], y[:8], y[8:])
    overrides = {"repeat": 1, "nn.epoch": 0, "nn.batch_size": 4}
    skip_step_compile(monkeypatch)
    want = jax_dual.run_dual_band(JaxConfig().override(overrides), data)

    def jax_initial(out, seed, channels):
        # JAX fit's initialisation for repeat seed ``seed``
        init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
        variables = jax.jit(lambda r, a: JaxDual(out).init(
            {"params": r, "dropout": r}, a, train=False))(
            init_rng, jnp.asarray(x[:2]))
        model = DualBandCNN(out, channels=channels, generator=gen())
        model.load_state_dict(state_dict_from_jax(
            "dual_band", jax.tree_util.tree_map(np.asarray, variables)),
            strict=True)
        return model

    monkeypatch.setattr(dual_band, "build_dual_band", jax_initial)
    got = runner.run_csi_model(Config().override(dict(
        overrides, model="dual_band")), data, device="cpu")
    assert set(got) == set(want)
    assert got["accuracy"]["avg"] == want["accuracy"]["avg"]
    for key, row in want["repeat_0"].items():
        for metric, value in row.items():
            assert got["repeat_0"][key][metric] == pytest.approx(
                value, rel=1e-12, abs=1e-15)


def strf_windows(n=6, t=120, c=5, seed=6):
    return np.random.default_rng(seed).standard_normal(
        (n, t, c)).astype(np.float32) * 3 + 1


def test_spectrogram_features_match_jax():
    x = strf_windows()
    np.testing.assert_array_equal(strf.spectrogram_features(x),
                                  jax_strf.spectrogram_features(x))
    got = spectrogram.strf_features(torch.from_numpy(x)).numpy()
    for want in (jax_strf.spectrogram_features(x),
                 np.asarray(jax_spectrogram.strf_features(jnp.asarray(x)))):
        assert got.shape == want.shape == (6, 5 * 9)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    for periodic in (False, True):
        np.testing.assert_array_equal(
            spectrogram.tukey_window(16, periodic=periodic),
            jax_spectrogram.tukey_window(16, periodic=periodic))


def test_device_features_match_one_pass():
    """The runner's features, FEATURE_CHUNK windows at a time, equal one
    pass of ``strf_features`` over all the windows, past a chunk's edge."""
    x = strf_windows(n=strf.FEATURE_CHUNK + 7, t=48, c=3, seed=9)
    got = strf.device_features(x, "cpu")
    want = spectrogram.strf_features(torch.from_numpy(x)).numpy()
    assert got.shape == (len(x), 3 * 9)
    np.testing.assert_array_equal(got, want)


def test_strf_result_matches_jax(monkeypatch):
    x = strf_windows(n=24, t=64, c=6, seed=7)
    y = labels(24, seed=8)
    data = (x[:16], x[16:], y[:16], y[16:])
    cfg = {"model": "ST-RF", "repeat": 2}
    got = runner.run_csi_model(Config().override(cfg), data, device="cpu")
    want = jax_runner.run_csi_model(JaxConfig().override(cfg), data)
    assert set(got) == set(want)
    assert got["accuracy"] == pytest.approx(want["accuracy"], rel=1e-12)
    for r in range(2):
        section = f"repeat_{r}"
        assert list(got[section]) == list(want[section])
        for key, row in want[section].items():
            for metric, value in row.items():
                assert got[section][key][metric] == pytest.approx(
                    value, rel=1e-12, abs=1e-15)

    # where sklearn is missing ST-RF says so
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    with pytest.raises(ImportError, match="needs sklearn"):
        runner.run_csi_model(Config().override(cfg), data, device="cpu")
