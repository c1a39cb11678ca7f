"""The port's runs that save, restore and resume, against the JAX
package's, on the CPU, at narrow widths.

- ``run_csi_model`` with ``save_model`` writes the component file of the
  run's best weights; that file under ``feature_encoder`` gives JAX's
  result dict from the same file, with nn.epoch 0 as
  test_torch_port_runner.py's ``run_both_from_one_checkpoint`` runs them
  (DETR at (300, 30); the fresh decoder carried over from JAX's initial
  weights, the feature extractor and encoder from the file).
- ``fit`` with run checkpoints for 2 epochs, then resumed to 3 on the same
  directory, against JAX's ``fit`` doing the same, per epoch, with
  test_torch_port_fit.py's settings (augmentation and dropout off, lr 5e-5)
  and tolerance (losses within 1e-4 relative, the discrete metrics equal):
  CNN-1D at (393, 20) in baseline mode, and DETR at (300, 30) in
  multi_head mode with the cosine-warmup schedule, whose step the
  resumed run restores (1 epoch, then resumed to 2). A checkpoint of
  another dtype is refused.
- ``cli/inspect_model.py`` gives JAX's report (query bias, metrics and the
  plots' statistics) on one JAX checkpoint, DETR over a dataset of
  (T, 30) windows.
"""

import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.cli import inspect_model as jax_inspect
from multi_modal_csi_tpu.core import checkpoint as jax_ckpt
from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.losses.matching import (
    HungarianMatchingLoss as JaxHungarian)
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu.train.loop import fit as jax_fit
from multi_modal_csi_tpu_torch.cli import inspect_model
from multi_modal_csi_tpu_torch.core import checkpoint
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.losses.matching import HungarianMatchingLoss
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.train.loop import fit
from test_torch_port_checkpoint import (OVERRIDES, config_file, jax_tree,
                                        port_model, skip_step_compile,
                                        write_narrow_dataset)
from test_torch_port_csi_baselines import pair as baseline_pair
from test_torch_port_fit import one_user_windows
from test_torch_port_runner import NARROW, assert_same_results, set_data
from test_torch_port_train_step import (DETR_SHAPE, detr_pair,  # noqa: F401
                                        no_dropout, no_jax_dropout)

torch.set_num_threads(1)

SETTINGS = dict(mode="baseline", lr=5e-5, batch_size=4, seed=0,
                augment=False)


@pytest.mark.filterwarnings("ignore:AOT train-step lowering failed")
def test_save_model_then_feature_encoder_matches_jax(tmp_path, monkeypatch):
    key = "DETR"
    overrides = dict(OVERRIDES, model=key, **{
        "nn.epoch": 0, "save_model": True, "saving_path": str(tmp_path),
        "pretrained_path": str(tmp_path / "start.pt")})
    data = set_data(NARROW[key])
    start = port_model(key, 13)
    torch.save(start.state_dict(), tmp_path / "start.pt")
    runner.run_csi_model(Config().override(overrides), data, device="cpu")
    saved = checkpoint.component_path(str(tmp_path), ["empty_room"], key)
    state = torch.load(saved, weights_only=True)
    assert set(state) == set(start.state_dict())
    for name, value in start.state_dict().items():
        assert torch.equal(state[name], value), name

    # feature_encoder from the saved file, in both packages; the fresh
    # decoder is JAX's initial one on both sides
    overrides.update({"save_model": False, "pretrained_path": saved,
                      "transfer_scenario": "feature_encoder"})
    captured = {}
    real_report = jax_runner.complexity_report

    def capture(model, variables, example):
        captured["v0"] = jax.tree_util.tree_map(np.asarray, variables)
        return real_report(model, variables, example)

    monkeypatch.setattr(jax_runner, "complexity_report", capture)
    skip_step_compile(monkeypatch)
    want = jax_runner.run_csi_model(JaxConfig().override(overrides), data)
    spec = runner.CSI_MODELS[key]
    init = state_dict_from_jax(key, captured["v0"], num_decoder_layers=2)

    def build(xs, out, cfg, g):
        model = spec.build(xs, out, cfg, g)
        model.load_state_dict(init, strict=True)
        return model

    monkeypatch.setitem(runner.CSI_MODELS, key,
                        dataclasses.replace(spec, build=build))
    got = runner.run_csi_model(Config().override(overrides), data,
                               device="cpu")
    assert_same_results(got, want, start)




def test_inspect_model_matches_jax(tmp_path, monkeypatch, capsys):
    overrides = dict(write_narrow_dataset(tmp_path, seed=2),
                     **{"nn.num_decoder_layers": 2, "nn.dim_ffn": 64})
    cfg_path = config_file(tmp_path / "cfg.json", overrides)
    jmodel, variables = jax_tree("DETR", port_model("DETR", 15))
    ckpt = str(tmp_path / "detr.msgpack")
    jax_ckpt.save_components(ckpt, variables["params"],
                             variables["batch_stats"])
    argv = ["--checkpoint", ckpt, "--model", "DETR", "--config", cfg_path]
    monkeypatch.setattr(sys, "argv", ["inspect_model"] + argv + [
        "--viz", str(tmp_path / "jax_viz")])
    jax_inspect.main()
    want = json.loads(capsys.readouterr().out)
    got = inspect_model.main(argv + ["--device", "cpu", "--viz",
                                     str(tmp_path / "viz")])
    got = json.loads(json.dumps(got, cls=inspect_model.NumpyJSONEncoder))
    assert got == want
    assert sum(want["query_bias"]["query_0"]) > 0
    names = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert len(names) == 5 and names == sorted(
        p.name for p in (tmp_path / "jax_viz").iterdir())


def compare_history(got, want):
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        assert mine["epoch"] == theirs["epoch"]
        for key in ("train_loss", "test_loss"):
            assert mine[key] == pytest.approx(theirs[key], rel=1e-4), key
        for key in ("perfect_prediction_percentage_test",
                    "perfect_prediction_percentage_train",
                    "total_error_test", "f1_score"):
            assert mine[key] == theirs[key], key


def resumed_runs(tmp_path, first, total, jax_args, port_args):
    """Each package's fit for ``first`` epochs with a checkpoint an epoch,
    then resumed to ``total`` epochs on the same directory: the two runs'
    histories for each."""
    out = {}
    for name, run, kwargs in (("jax", jax_fit, jax_args),
                              ("port", fit, port_args)):
        d = str(tmp_path / name)
        out[name] = [run(**kwargs(), epochs=epochs, checkpoint_dir=d,
                         checkpoint_every=1).history
                     for epochs in (first, total)]
    return out


def test_resumed_fit_matches_jax(tmp_path, no_jax_dropout):
    jmodel, variables, _ = baseline_pair("CNN-1D")
    x_tr, y_tr = one_user_windows(12, seed=3)
    x_va, y_va = one_user_windows(10, seed=4)
    rng = np.random.default_rng(5)
    x_tr, x_va = (rng.standard_normal((len(a), 393, 20), dtype=np.float32)
                  for a in (x_tr, x_va))
    init = (variables["params"], variables["batch_stats"])

    def port_args():
        return dict(model=no_dropout(baseline_pair("CNN-1D")[2]),
                    x_train=x_tr, y_train=y_tr, x_valid=x_va, y_valid=y_va,
                    loss_fn=lambda o, t: bce_with_logits(o, t, 4.0),
                    device="cpu", **SETTINGS)

    runs = resumed_runs(tmp_path, 2, 3, lambda: dict(
        model=jmodel, x_train=x_tr, y_train=y_tr, x_valid=x_va,
        y_valid=y_va, loss_fn=lambda o, t: jax_bce(o, t, 4.0),
        init_variables=init, **SETTINGS), port_args)
    for got, want in zip(runs["port"], runs["jax"]):
        compare_history(got, want)
    assert [h["epoch"] for h in runs["port"][1]] == [2]
    ckpt = checkpoint.RunCheckpointer(str(tmp_path / "port"))
    assert ckpt.latest_step() == 2 and ckpt.restore()["epoch"] == 2

    # a bf16 run refuses the f32 checkpoint
    with pytest.raises(ValueError, match="train_dtype"):
        fit(**port_args(), epochs=4, checkpoint_dir=str(tmp_path / "port"),
            checkpoint_every=1, train_dtype="bfloat16")


def test_resumed_multi_head_fit_restores_the_schedule(tmp_path,
                                                      no_jax_dropout):
    jmodel, variables, _ = detr_pair()
    rng = np.random.default_rng(6)
    x_tr, x_va = (rng.standard_normal((n,) + DETR_SHAPE[1:],
                                      dtype=np.float32) for n in (12, 6))
    y_tr, y_va = (np.eye(10, dtype=np.float32)[rng.integers(0, 10, (n, 5))]
                  for n in (12, 6))
    settings = dict(SETTINGS, mode="multi_head", batch_axis=1,
                    warmup_epochs=1, min_lr_ratio=0.05)
    init = (variables["params"], variables["batch_stats"])
    made = []

    def port_args():
        made.append(no_dropout(detr_pair()[2]))
        return dict(model=made[-1], x_train=x_tr, y_train=y_tr,
                    x_valid=x_va, y_valid=y_va,
                    loss_fn=HungarianMatchingLoss(), device="cpu",
                    **settings)

    runs = resumed_runs(tmp_path, 1, 2, lambda: dict(
        model=jmodel, x_train=x_tr, y_train=y_tr, x_valid=x_va,
        y_valid=y_va, loss_fn=JaxHungarian(), init_variables=init,
        **settings), port_args)
    for got, want in zip(runs["port"], runs["jax"]):
        compare_history(got, want)
    state = checkpoint.RunCheckpointer(str(tmp_path / "port")).restore(0)
    assert state["scheduler"]["last_epoch"] == 2      # 2 steps an epoch
    assert state["optimizer"]["state"]
    assert [h["epoch"] for h in runs["port"][1]] == [1]
