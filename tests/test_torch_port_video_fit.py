"""The port's video training (runners/video.py::fit_video, run_video_model
and cli/run_video.py) on the CPU.

- ``fit_video`` against the JAX package's, epoch by epoch: a tiny model
  defined here on both sides (flatten, Dense 16, ReLU, Dense 2), its JAX
  initial weights carried to the port, in-memory ArrayClips of (2, 4, 4, 3)
  clips whose two labels are the signs of two channel means, lr 1e-2,
  batch 4, 3 epochs with 18 training clips (4 full batches an epoch, the
  tail of 2 left out) and 8 test clips, the same seed on both sides (so
  the same shuffles). Compared per epoch: the last batch's loss within
  1e-5 relative, the training and test accuracies equal; then the best
  accuracy, and the best weights within 1e-6;
- the best weights start as the initial weights and only a strictly
  higher test accuracy replaces them;
- ``run_video_model`` through ``cli/run_video.py`` at a tiny (4, 32, 32)
  MViT-v2 clip, repeat 1, epoch 1, batch 2, on the CPU: the result JSON
  has the JAX runner's keys (``runners/video.py:392-406`` there, with the
  CLI's model and task);
- the options that wait for other ROADMAP items raise
  NotImplementedError; a backbone the JAX package does not have (every
  one it has is ported) raises KeyError.
"""

import csv
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multi_modal_csi_tpu.data.video_io import ArrayClips as JaxClips
from multi_modal_csi_tpu.runners.video import fit_video as jax_fit_video
from multi_modal_csi_tpu_torch.cli import run_video
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.data.video_io import ArrayClips
from multi_modal_csi_tpu_torch.runners.video import (fit_video,
                                                     run_video_model)

torch.set_num_threads(1)

CLIP = (2, 4, 4)
SETTINGS = dict(lr=1e-2, epochs=3, batch_size=4, seed=0, threshold=0.5,
                verbose=False, num_workers=1)
JAX_RESULT_KEYS = {"complexity", "repeat_0", "accuracy", "time_train",
                   "time_test", "model", "task"}


class JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1)
        return fnn.Dense(2, name="out")(
            fnn.relu(fnn.Dense(16, name="hidden")(x)))


class TorchTiny(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.hidden = nn.Linear(int(np.prod(CLIP)) * 3, 16)
        self.out = nn.Linear(16, 2)
        with torch.no_grad():
            for name in ("hidden", "out"):
                layer = getattr(self, name)
                layer.weight.copy_(torch.from_numpy(
                    np.array(params[name]["kernel"]).T))
                layer.bias.copy_(torch.from_numpy(
                    np.array(params[name]["bias"])))

    def forward(self, x):
        return self.out(torch.relu(self.hidden(x.reshape(x.shape[0], -1))))


def clips(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *CLIP, 3), dtype=np.float32)
    y = np.stack([x[..., 0].mean(axis=(1, 2, 3)) > 0,
                  x[..., 1].mean(axis=(1, 2, 3)) > 0], axis=1)
    return x, y.astype(np.float32)


def test_fit_video_matches_jax_per_epoch():
    (x_tr, y_tr), (x_te, y_te) = clips(18, 1), clips(8, 2)
    jmodel = JaxTiny()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x_tr[:1]))[
        "params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    want_history, got_history = [], []
    (want_best, _), want_acc = jax_fit_video(
        jmodel, JaxClips(x_tr, y_tr), JaxClips(x_te, y_te),
        init_variables=(params, {}), history=want_history, **SETTINGS)
    model = TorchTiny(params)
    got_best, got_acc = fit_video(
        model, ArrayClips(x_tr, y_tr), ArrayClips(x_te, y_te),
        history=got_history, device="cpu", **SETTINGS)
    assert len(got_history) == len(want_history) == 3
    for mine, theirs in zip(got_history, want_history):
        print(mine, theirs)
        assert mine["epoch"] == theirs["epoch"]
        assert mine["train_loss"] == pytest.approx(theirs["train_loss"],
                                                   rel=1e-5)
        assert mine["train_acc"] == theirs["train_acc"]
        assert mine["test_acc"] == theirs["test_acc"]
    assert got_acc == want_acc > 0
    for name in ("hidden", "out"):
        np.testing.assert_allclose(got_best[f"{name}.weight"].numpy(),
                                   np.asarray(want_best[name]["kernel"]).T,
                                   atol=1e-6)
        np.testing.assert_allclose(got_best[f"{name}.bias"].numpy(),
                                   np.asarray(want_best[name]["bias"]),
                                   atol=1e-6)


def test_best_weights_start_as_the_initial_weights():
    """A threshold of 1 predicts no label, so every test clip, whose
    labels are all 1, is wrong: no epoch beats the initial accuracy of 0,
    and the initial weights come back though training moved them."""
    (x_tr, y_tr), (x_te, _) = clips(8, 1), clips(4, 2)
    params = jax.tree_util.tree_map(np.asarray, JaxTiny().init(
        jax.random.PRNGKey(0), jnp.asarray(x_tr[:1]))["params"])
    model = TorchTiny(params)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    history = []
    best, acc = fit_video(model, ArrayClips(x_tr, y_tr),
                          ArrayClips(x_te, np.ones((4, 2), np.float32)),
                          history=history, device="cpu",
                          **dict(SETTINGS, threshold=1.0, epochs=2))
    assert acc == 0.0 and [h["test_acc"] for h in history] == [0.0, 0.0]
    assert all(torch.equal(best[k], initial[k]) for k in initial)
    assert not torch.equal(model.state_dict()["out.bias"],
                           initial["out.bias"])


def write_clip_cache(root, n, clip, seed=3):
    """annotation.csv of ``n`` empty-room clips and their cached .npy
    clips of ``clip`` frames."""
    rng = np.random.default_rng(seed)
    header = ["label", "environment", "wifi_band", "number_of_users"] + [
        f"user_{u}_{what}" for u in range(1, 7)
        for what in ("location", "activity")]
    with open(root / "annotation.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        for i in range(n):
            users = int(rng.integers(0, 4))
            row = [f"act_{i}", "empty_room", "5", str(users)]
            for u in range(6):
                row += ["a", "walk"] if u < users else ["", ""]
            writer.writerow(row)
            np.save(root / f"act_{i}.npy", rng.standard_normal(
                (*clip, 3), dtype=np.float32))


def test_run_video_cli_on_cpu(tmp_path, capsys):
    write_clip_cache(tmp_path, 10, (4, 32, 32))
    save = tmp_path / "out" / "result.json"
    result = run_video.main([
        "--model", "MViT-v2", "--repeat", "1", "--device", "cpu",
        "--set", f"path.video_pre_x={tmp_path}",
        "--set", f"path.data_y={tmp_path / 'annotation.csv'}",
        "--set", f"path.save={save}", "--set", "nn.epoch=1",
        "--set", "nn.batch_size=2"])
    written = json.loads(save.read_text())
    assert set(written) == set(result) == JAX_RESULT_KEYS
    assert written["model"] == "MViT-v2" and written["task"] == "identity"
    assert written["complexity"]["parameter"] > 3e7
    assert set(written["repeat_0"]) >= {"0", "5", "micro avg",
                                        "samples avg"}
    assert 0.0 <= written["accuracy"]["avg"] <= 1.0
    assert written["accuracy"]["std"] == 0.0
    assert "Epoch 0/1" in capsys.readouterr().out


@pytest.mark.parametrize("option", ["mesh", "backbone", "sharding",
                                    "cli-mesh", "cli-distributed"])
def test_unported_options_raise(option):
    cfg = Config().override({"model": "MViT-v1"})
    x = np.zeros((2, *CLIP, 3), np.float32)
    y = np.zeros((2, 6), np.float32)
    data = (x, x, y, y)
    if option == "backbone":
        with pytest.raises(KeyError, match="unknown video model"):
            run_video_model(cfg.override({"model": "Swin-B"}), data,
                            device="cpu")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP item 1[24]"):
        if option == "mesh":
            run_video_model(cfg, data, use_mesh=True, device="cpu")
        elif option == "sharding":
            fit_video(TorchTiny(JaxTiny().init(
                jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]),
                ArrayClips(x, y[:, :2]), ArrayClips(x, y[:, :2]),
                fsdp=True, device="cpu", **SETTINGS)
        else:
            run_video.main(["--" + option[4:], "--device", "cpu"])
