"""The port's ops layer against the JAX package's, on the CPU.

- ``utils/logging.py::MetricWriter``: the same records give the same
  stdout lines and the same JSONL lines but ``_time``; with a W&B project
  and no wandb, the same stderr notice.
- ``run_csi_model(writer_factory=...)`` on JAX's own writer test (MLP,
  ``tests/test_runners.py``'s data, two repeats): the same writer names and
  key sets as JAX's run; the summaries and aggregates equal to the port's
  result dict, the epoch records to ``fit``'s history.
- ``utils/profiling.py``: ``StepTimer.summary`` equal to JAX's to 1e-12 on
  the same times; ``trace`` writes a Chrome trace naming a forward's ops;
  ``nan_guard`` raises on a NaN made in a forward, in a backward and by a
  hand kernel's launch, and a clean THAT_ENCODER step under it is bit-equal
  to one outside it.
- ``utils/explore.py``: ``packet_loss_stats`` and ``label_distribution``
  equal to JAX's (``label_distribution`` on the DataFrame JAX's
  ``load_annotation`` reads, key types and order included), and the PNGs.
- ``cli/sweep.sh`` and ``jobs/gpu-job.sh`` as ``tests/test_shell_drivers.py``
  checks JAX's; a JAX config file with the observability fields loads.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.data.annotation import (
    load_annotation as jax_load_annotation)
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu.utils import explore as jax_explore
from multi_modal_csi_tpu.utils.logging import MetricWriter as JaxWriter
from multi_modal_csi_tpu.utils.profiling import StepTimer as JaxTimer
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.core.config import Config, load_config
from multi_modal_csi_tpu_torch.data.annotation import load_annotation
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.utils import explore
from multi_modal_csi_tpu_torch.utils.logging import MetricWriter
from multi_modal_csi_tpu_torch.utils.profiling import (StepTimer, nan_guard,
                                                       trace)
from test_runners import _synth, _tiny_cfg
from test_torch_port_data import write_annotation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = os.path.join(REPO, "multi_modal_csi_tpu_torch", "cli", "sweep.sh")
GPU_JOB = os.path.join(REPO, "multi_modal_csi_tpu_torch", "jobs",
                       "gpu-job.sh")
RECORDS = [({"loss": 0.25, "epoch": 3, "name": "x"}, 3),
           ({"acc": np.float32(0.5), "n": np.int64(7),
             "one": np.array([1.5], np.float32)}, None),
           ({"f1": 1.0 / 3.0}, 12)]


def write_records(writer_cls, path, records):
    writer = writer_cls(jsonl_path=str(path))
    for metrics, step in records:
        writer.log(metrics, step=step)
    writer.finish()
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    for line in lines:
        assert isinstance(line.pop("_time"), float)
    return lines


def test_metric_writer_matches_jax(tmp_path, capsys):
    want = write_records(JaxWriter, tmp_path / "jax.jsonl", RECORDS)
    jax_out = capsys.readouterr().out
    got = write_records(MetricWriter, tmp_path / "port.jsonl", RECORDS)
    assert capsys.readouterr().out == jax_out
    assert got == want
    assert jax_out.splitlines()[0] == (
        "step 3 - loss 0.250000 - epoch 3 - name x")
    # 0-d and one-element tensors are read as the numpy scalars are
    tensors = [({"acc": torch.tensor(0.5), "n": torch.tensor(7),
                 "one": torch.tensor([1.5])}, None)]
    assert write_records(MetricWriter, tmp_path / "t.jsonl",
                         tensors) == want[1:2]
    assert capsys.readouterr().out == jax_out.splitlines(True)[1]


def test_metric_writer_without_wandb(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)   # import fails
    JaxWriter(wandb_project="p", verbose=False).log({"a": 1.0})
    want = capsys.readouterr()
    MetricWriter(wandb_project="p", verbose=False).log({"a": 1.0})
    got = capsys.readouterr()
    assert got.err == want.err and "[metrics] wandb unavailable" in got.err
    assert got.out == want.out == ""


class Capture:
    """A writer that keeps each run's records by name."""

    def __init__(self, records, name):
        self.records = records.setdefault(name, [])

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))

    def finish(self):
        self.records.append("finished")


# tests/test_runners.py::_tiny_cfg("MLP") with two repeats
TINY_MLP = {"model": "MLP", "repeat": 2, "nn.epoch": 1, "nn.batch_size": 8,
            "nn.patience": 10, "nn.token_length": 10,
            "nn.num_decoder_layers": 2, "nn.dim_ffn": 32}


def test_runner_writers_match_jax(monkeypatch):
    data = _synth()
    histories = []
    fit = runner.fit

    def keep_fit(*args, **kwargs):
        res = fit(*args, **kwargs)
        histories.append(res.history)
        return res

    monkeypatch.setattr(runner, "fit", keep_fit)
    got, want = {}, {}
    result = runner.run_csi_model(
        Config().override(TINY_MLP), data, device="cpu",
        writer_factory=lambda name: Capture(got, name))
    jax_cfg = _tiny_cfg("MLP").override({"repeat": 2})
    assert jax_cfg == JaxConfig().override(TINY_MLP)
    jax_runner.run_csi_model(jax_cfg, data,
                             writer_factory=lambda name: Capture(want, name))

    def keys(records):
        return [sorted(r) if isinstance(r, dict) else r for r in records]

    assert list(got) == list(want) == ["MLP_0", "MLP_1", "MLP_aggregate"]
    for name in want:
        assert keys(got[name]) == keys(want[name]), name
    assert len(histories) == 2
    for r, history in enumerate(histories):
        *epochs, summary, finished = got[f"MLP_{r}"]
        assert epochs == history and finished == "finished"
        assert set(summary) == {"summary/test_accuracy",
                                "summary/time_train", "summary/time_test"}
    accuracies = [got[f"MLP_{r}"][-2]["summary/test_accuracy"]
                  for r in range(2)]
    assert float(np.mean(accuracies)) == result["accuracy"]["avg"]
    assert float(np.std(accuracies)) == result["accuracy"]["std"]
    assert got["MLP_aggregate"] == [{
        "aggregate/accuracy_avg": result["accuracy"]["avg"],
        "aggregate/accuracy_std": result["accuracy"]["std"],
        "aggregate/time_train_avg": result["time_train"]["avg"],
        "aggregate/time_test_avg": result["time_test"]["avg"]}, "finished"]


def test_step_timer_summary_matches_jax():
    times = list(np.random.default_rng(0).uniform(1e-3, 2e-2, size=13))
    port, jax = StepTimer(), JaxTimer()
    assert port.summary() == jax.summary() == {}
    port.times, jax.times = list(times), list(times)
    got, want = port.summary(), jax.summary()
    assert set(got) == set(want) and got["steps"] == want["steps"] == 13
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)
    timer = StepTimer()
    for result in (torch.ones(2), {"a": [torch.ones(1), (3, None)]}, None):
        timer.start()
        timer.stop(result)
    assert len(timer.times) == 3 and min(timer.times) >= 0


def test_trace_writes_a_trace_of_the_ops(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.ReLU())
    with trace(str(tmp_path)) as prof:
        model(torch.ones(2, 8)).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::linear", "aten::relu", "aten::sum"} <= names
    assert "aten::linear" in {e.key for e in prof.key_averages()}


def encoder_step(model, x, y, loss_fn):
    """Logits and gradients of one THAT_ENCODER forward and backward, with
    the dropout masks drawn from one seed."""
    torch.manual_seed(1)
    model.zero_grad()
    out = model(x)
    loss_fn(out, y).backward()
    return [out.detach()] + [p.grad.clone() for p in model.parameters()]


def test_nan_guard_on_a_that_encoder_step():
    """Clean: the logits and every gradient bit-equal to the unguarded
    step's. A NaN in one input window raises at the op that first reads
    it."""
    cfg = Config()
    spec = runner.CSI_MODELS["THAT_ENCODER"]
    model = spec.build((300, 90), 10, cfg,
                       torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 300, 90), np.float32))
    y = torch.from_numpy(np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (4, 5))])
    loss_fn = spec.make_loss(cfg, 10)
    plain = encoder_step(model, x, y, loss_fn)
    with nan_guard():
        guarded = encoder_step(model, x, y, loss_fn)
    assert len(plain) == len(guarded) > 100
    assert all(torch.equal(a, b) for a, b in zip(plain, guarded))
    x[1, 7, 3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"output of aten\."):
        with nan_guard():
            encoder_step(model, x, y, loss_fn)


def test_nan_guard_forward_backward_and_launches():
    w = torch.tensor([1.0, 0.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match="aten.log.default"):
        with nan_guard():
            torch.log(w - 2.0)
    # sqrt is finite at 0; its gradient there is 0 / 0 in the backward
    z = (torch.sqrt(w) * torch.tensor([1.0, 0.0])).sum()
    with pytest.raises(FloatingPointError, match="aten.div.Tensor"):
        with nan_guard():
            z.backward()
    # what a hand kernel launched through ctypes wrote
    nan = torch.tensor([0.0, float("nan")])
    with pytest.raises(FloatingPointError, match="the K9 kernel"):
        with nan_guard():
            kernels.check_launch("K9", (torch.zeros(2), nan))
    # outside the block nothing is checked, and in it nothing unwritten
    kernels.check_launch("K9", (nan,))
    assert torch.isnan(torch.log(w - 2.0)).all()
    with nan_guard():
        torch.empty(1000).fill_(1.0)
        torch.isnan(nan)              # a bool result holds no NaN


def test_explore_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i, t in enumerate([3000, 2400, 1500]):
        np.save(tmp_path / f"s{i}.npy",
                rng.normal(size=(t, 3, 3, 30)).astype(np.float32))
    labels = ["s0", "s1", "s2"]
    assert explore.packet_loss_stats(str(tmp_path), labels, 3000) == \
        jax_explore.packet_loss_stats(str(tmp_path), labels, 3000)

    # JAX's load_annotation reads every cell as a string (dtype=str), so
    # number_of_users' keys are strings on both sides
    path = str(tmp_path / "annotation.csv")
    write_annotation(path, n=200, seed=3)
    got = explore.label_distribution(load_annotation(path))
    want = jax_explore.label_distribution(jax_load_annotation(path))
    assert got == want
    for key in want:
        assert [(type(k), k, type(v)) for k, v in got[key].items()] == [
            (type(k), k, type(v)) for k, v in want[key].items()], key
    assert set(got["number_of_users"]) == {str(u) for u in range(6)}
    assert "nan" not in got["activity"]

    explore.csi_heatmap(np.load(tmp_path / "s2.npy")[:120],
                        save_path=str(tmp_path / "plots" / "heat.png"))
    explore.plot_label_distribution(load_annotation(path),
                                    str(tmp_path / "dist"))
    assert os.path.getsize(tmp_path / "plots" / "heat.png") > 0
    assert sorted(os.listdir(tmp_path / "dist")) == [
        f"dist_{key}.png" for key in sorted(want)]


def bash(args, env=None):
    return subprocess.run(["bash"] + args, capture_output=True, text=True,
                          env=dict(os.environ, **(env or {})), cwd=REPO,
                          timeout=60)


def test_sweep_and_job_scripts():
    for script in (SWEEP, GPU_JOB):
        r = bash(["-n", script])
        assert r.returncode == 0, (script, r.stderr)
    r = bash([SWEEP], {"DRY_RUN": "1", "MODELS": "MLP DETR",
                       "USER_SETS": "0 1,2"})
    assert r.returncode == 0, r.stderr
    cmds = [ln for ln in r.stdout.splitlines() if ln.startswith("DRY ")]
    assert len(cmds) == 4, r.stdout
    assert all("-m multi_modal_csi_tpu_torch.cli.run_csi " in c
               for c in cmds)
    assert "--model MLP" in cmds[0] and "--users 0" in cmds[0], cmds[0]
    assert "result_DETR_12.json" in cmds[-1], cmds[-1]
    r = bash([GPU_JOB], {"DRY_RUN": "1", "DATA_PATH": "/tmp/wimans",
                         "MODEL_TYPE": "THAT", "REPEAT": "2"})
    assert r.returncode == 0, r.stderr
    cmds = [ln for ln in r.stdout.splitlines() if ln.startswith("DRY ")]
    assert len(cmds) == 1, r.stdout
    assert cmds[0].startswith(
        "DRY python -m multi_modal_csi_tpu_torch.cli.run_csi ")
    assert "--model THAT" in cmds[0] and "--repeat 2" in cmds[0], cmds[0]
    with open(GPU_JOB) as f:
        assert "#SBATCH --gres=gpu:1\n" in f.read()
    env = {k: v for k, v in os.environ.items() if k != "DATA_PATH"}
    r = subprocess.run(["bash", GPU_JOB], capture_output=True, text=True,
                       env=dict(env, DRY_RUN="1"), cwd=REPO, timeout=60)
    assert r.returncode != 0 and "DATA_PATH" in r.stderr


def test_jax_config_with_observability_fields_loads(tmp_path):
    fields = {"wandb_project": "wimans", "log_jsonl": "runs/m.jsonl",
              "profile_dir": "traces"}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(fields, model="THAT")))
    cfg = load_config(str(path), use_env=False)
    assert cfg.model == "THAT"
    for key, value in fields.items():
        assert getattr(cfg, key) == value == getattr(
            JaxConfig().override({key: value}), key)
        assert getattr(Config(), key) is None is getattr(JaxConfig(), key)
