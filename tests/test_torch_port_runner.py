"""The port's CSI experiment runner (runners/csi.py, cli/run_csi.py) against
the JAX package's, on the CPU.

- ``master_split`` on a synthetic annotation.csv (two environments, empty
  cells for absent users) and an amplitude cache of (T, 3, 3, 30) windows
  of 150 to 260 steps, padded to 240: every array equal.
- The final evaluators on the same logits: ``_final_report`` (subset
  accuracy and the classification report) equal to 1e-12 relative, and
  ``_count_round_metrics`` equal.
- ``run_csi_model`` for THAT_ENCODER and DETR at narrow widths, both
  packages starting from the same reference-layout ``.pt``
  (``pretrained_path``, scenario ``full``; THAT_ENCODER's file carries the
  reference's dead head-conv parameters, which both drop) with
  ``nn.epoch`` 0, so the final test pass runs the restored weights in f32:
  the result dicts agree key for key, every metric (all are functions of
  argmax one-hots) equal, and ``complexity.parameter`` equal; the time and
  FLOP entries are the only ones not compared (wall times; XLA's cost
  analysis against PyTorch's FLOP counter).
- ``cli/run_csi.py`` end to end with ``--device cpu``, writing the JSON.
- Restored weights train with plain Adam at lr (no weight decay, no
  schedule); metric writers get a run's summary and aggregate, and a
  device mesh asked for on the card where there is none raises.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu_torch.cli import run_csi
from multi_modal_csi_tpu_torch.core import checkpoint
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.data.encoders import reduce_dataset
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.train import transfer
from test_torch_port_data import write_annotation

torch.set_num_threads(1)

RESULT_KEYS = {"complexity", "repeat_0", "accuracy", "time_train",
               "time_test", "final_metrics", "model", "task", "data", "nn"}


def write_dataset(root, n=40, seed=0, steps=(150, 260)):
    """annotation.csv under ``root`` and one (T, 3, 3, 30) amplitude file
    per label under ``root/amp``."""
    os.makedirs(root / "amp", exist_ok=True)
    write_annotation(str(root / "annotation.csv"), n=n, seed=seed)
    rng = np.random.default_rng(seed)
    with open(root / "annotation.csv") as f:
        for row in csv.DictReader(f):
            t = int(rng.integers(*steps))
            np.save(root / "amp" / f"{row['label']}.npy",
                    rng.random((t, 3, 3, 30), dtype=np.float32))


def dataset_overrides(root, length=240):
    return {"path.data_x": str(root / "amp"),
            "path.data_y": str(root / "annotation.csv"),
            "data.environment": ["classroom", "meeting_room"],
            "data.wifi_band": ["2.4", "5"], "data.length": length}


@pytest.mark.parametrize("target", ["raw", "reduce_pad", "reduce_sum"])
def test_master_split_matches_jax(tmp_path, target):
    write_dataset(tmp_path)
    overrides = dataset_overrides(tmp_path)
    got = runner.master_split(Config().override(overrides), target)
    want = jax_runner.master_split(JaxConfig().override(overrides), target)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)
    assert got[0].shape[1:] == (240, 3, 3, 30)


def test_final_evaluators_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((30, 54)).astype(np.float32)
    y = (rng.random((30, 6, 9)) < 0.1).astype(np.float32)
    acc, report = runner._final_report(logits, y.reshape(30, -1), 0.5)
    j_acc, j_report = jax_runner._final_report(logits, y.reshape(30, -1),
                                               0.5)
    assert acc == j_acc and list(report) == list(j_report)
    for key, row in j_report.items():
        for metric, value in row.items():
            assert report[key][metric] == pytest.approx(value, rel=1e-12,
                                                         abs=1e-15)
    counts = rng.random((30, 54)).astype(np.float32) * 1.5
    got = runner._count_round_metrics(counts, y)
    want = jax_runner._count_round_metrics(counts, y)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def perturbed(model, seed):
    """Every parameter moved by seeded noise (a shared module's once) and
    BatchNorm statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p += torch.from_numpy(
                0.02 * rng.standard_normal(p.shape).astype(np.float32))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, b.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                b.copy_(torch.from_numpy(
                    0.1 * rng.standard_normal(b.shape).astype(np.float32)))
    return model


def set_data(shape, n_tr=10, n_te=8, seed=4):
    """(x_tr, x_te, y_tr, y_te) at ``shape`` windows, reduce_pad targets."""
    rng = np.random.default_rng(seed)
    n = n_tr + n_te
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = np.zeros((n, 6, 9), np.int64)
    for i in range(n):
        k = int(rng.integers(0, 6))
        y[i, :k] = np.eye(9, dtype=np.int64)[rng.integers(0, 9, size=k)]
    y = reduce_dataset(y, 5).astype(np.float32)
    return x[:n_tr], x[n_tr:], y[:n_tr], y[n_tr:]


NARROW = {"THAT_ENCODER": (1280, 90), "DETR": (300, 30)}


def run_both_from_one_checkpoint(key, tmp_path):
    """The port's and JAX's run_csi_model result dicts for ``key``, both
    restored from one ``.pt``, with nn.epoch 0; also the port model whose
    weights the file holds."""
    overrides = {"model": key, "repeat": 1, "nn.epoch": 0,
                 "nn.batch_size": 4, "nn.num_decoder_layers": 2,
                 "nn.dim_ffn": 64, "transfer_scenario": "full",
                 "pretrained_path": str(tmp_path / "weights.pt")}
    cfg = Config().override(overrides)
    data = set_data(NARROW[key])
    model = perturbed(runner.CSI_MODELS[key].build(
        NARROW[key], 10, cfg, torch.Generator().manual_seed(5)), seed=6)
    state = dict(model.state_dict())
    if key == "THAT_ENCODER":        # the reference's unused head convs
        for name in checkpoint._DEAD_KEYS[key]:
            state[name] = torch.ones(3)
    torch.save(state, tmp_path / "weights.pt")
    got = runner.run_csi_model(cfg, data, device="cpu")
    want = jax_runner.run_csi_model(JaxConfig().override(overrides), data)
    return got, want, model


def assert_same_results(got, want, model):
    assert set(got) == set(want) == RESULT_KEYS - {"model", "task", "data",
                                                    "nn"}
    assert got["complexity"]["parameter"] == want["complexity"]["parameter"]
    assert got["complexity"]["parameter"] == sum(
        p.numel() for p in model.parameters())
    assert got["complexity"]["flops"] > 0
    for section in ("repeat_0", "final_metrics", "accuracy"):
        assert set(got[section]) == set(want[section]), section
        for name, value in want[section].items():
            np.testing.assert_array_equal(got[section][name], value,
                                          err_msg=f"{section}.{name}")


def test_that_encoder_run_matches_jax_from_one_checkpoint(tmp_path):
    got, want, model = run_both_from_one_checkpoint("THAT_ENCODER", tmp_path)
    assert_same_results(got, want, model)
    print(got["repeat_0"])


def test_restored_weights_train_with_plain_adam(tmp_path, monkeypatch):
    """Scenario full: Adam at lr without weight decay, and no schedule (the
    lr is unchanged after an epoch of multi_head training)."""
    made = []
    real = transfer.adam_like_torch

    def recording(params, lr, weight_decay=0.0):
        made.append((real(params, lr, weight_decay), lr, weight_decay))
        return made[-1][0]

    monkeypatch.setattr(transfer, "adam_like_torch", recording)
    model = runner.CSI_MODELS["DETR"].build(
        NARROW["DETR"], 10, Config(), torch.Generator().manual_seed(7))
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    cfg = Config().override({"model": "DETR", "repeat": 1, "nn.epoch": 1,
                             "nn.batch_size": 4, "nn.lr": 1e-3,
                             "pretrained_path": str(tmp_path / "weights.pt")})
    result = runner.run_csi_model(cfg, set_data(NARROW["DETR"]),
                                  device="cpu")
    assert [(lr, wd) for _, lr, wd in made] == [(1e-3, 0.0)]
    assert made[0][0].param_groups[0]["lr"] == 1e-3
    assert np.isfinite(result["accuracy"]["avg"])


def test_pretrained_drops_only_the_dead_parameters(tmp_path):
    """THAT_ENCODER's unused reference head convs are dropped; any other
    key the port model lacks fails the strict load."""
    model = runner.build_model("THAT_ENCODER", cfg=Config().override(
        {"data.length": 1280}))
    state = dict(model.state_dict())
    for name in checkpoint._DEAD_KEYS["THAT_ENCODER"]:
        state[name] = torch.zeros(2)
    torch.save(state, tmp_path / "weights.pt")
    loaded = checkpoint.load_pretrained(str(tmp_path / "weights.pt"),
                                    "THAT_ENCODER")
    assert set(loaded) == set(model.state_dict())
    model.load_state_dict(loaded, strict=True)
    state["encoder.layer_left_cnn_2.weight"] = torch.zeros(2)
    torch.save(state, tmp_path / "weights.pt")
    with pytest.raises(RuntimeError, match="layer_left_cnn_2"):
        model.load_state_dict(checkpoint.load_pretrained(
            str(tmp_path / "weights.pt"), "THAT_ENCODER"), strict=True)


def test_run_cli_on_cpu_writes_json(tmp_path):
    """annotation.csv and amplitude cache to the result JSON, with the
    final pass in bf16 ("auto")."""
    write_dataset(tmp_path, n=60, seed=1)
    save = tmp_path / "out" / "result.json"
    args = ["--model", "DETR", "--task", "activity", "--repeat", "1",
            "--users", "0,1,2,3,4,5", "--device", "cpu"]
    for key, value in dict(dataset_overrides(tmp_path), **{
            "path.save": str(save), "nn.epoch": 1, "nn.batch_size": 4,
            "nn.num_decoder_layers": 2, "compute_dtype": "auto"}).items():
        value = ",".join(value) if isinstance(value, list) else value
        args += ["--set", f"{key}={value}"]
    result = run_csi.main(args)
    written = json.loads(save.read_text())
    assert set(written) == set(result) == RESULT_KEYS
    assert written["model"] == "DETR" and written["data"]["length"] == 240
    assert written["nn"]["num_decoder_layers"] == 2
    assert written["data"]["environment"] == ["classroom", "meeting_room"]
    assert 0.0 <= written["accuracy"]["avg"] <= 100.0
    assert written["complexity"]["flops"] > 0


@pytest.mark.parametrize("what", ["writer", "mesh"])
def test_what_is_not_ported_raises(what):
    """Metric writers are ported: a DETR run logs its repeat's summary and
    the aggregate (the epoch records and JAX's run are
    tests/test_torch_port_ops.py's). The mesh is ported (the 2-rank runs
    are tests/test_torch_port_data_parallel.py's); asked for on the card
    where there is none, it raises rather than run on the CPU."""
    cfg = Config().override({"model": "DETR"})
    if what == "writer":
        logged = {}

        class Writer:
            def __init__(self, name):
                self.records = logged.setdefault(name, [])

            def log(self, metrics, step=None):
                self.records.append((step, dict(metrics)))

            def finish(self):
                self.records.append("finished")

        cfg = cfg.override({"repeat": 1, "nn.epoch": 0, "nn.batch_size": 4,
                            "nn.num_decoder_layers": 2, "nn.dim_ffn": 64})
        result = runner.run_csi_model(cfg, set_data(NARROW["DETR"]),
                                      device="cpu", writer_factory=Writer)
        assert list(logged) == ["DETR_0", "DETR_aggregate"]
        (step, summary), finished = logged["DETR_0"]
        assert step is None and finished == "finished"
        assert summary["summary/test_accuracy"] == result["accuracy"]["avg"]
        assert {f"summary/{k}" for k, v in result["final_metrics"].items()
                if np.isscalar(v)} <= set(summary)
        assert logged["DETR_aggregate"][0][1]["aggregate/accuracy_avg"] \
            == result["accuracy"]["avg"]
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            runner.run_csi_model(cfg, set_data(NARROW["DETR"]),
                                 device="cuda", use_mesh=True)
    with pytest.raises(KeyError, match="unknown model"):
        runner.build_model("THAT_DECODER")
