"""The port's multi-node launcher (``jobs/gpu-multinode.sh`` and
``jobs/gpu-multinode-jobset.yaml``) and its card rule, on the CPU.

- The script parses (``bash -n``); ``DRY_RUN=1`` prints one torchrun
  command that runs JAX's ``run_csi`` flags of
  ``jobs/tpu-multihost-jobset.yaml`` word for word (the package renamed),
  takes the rendezvous from SLURM's variables under SLURM (a stub
  ``scontrol`` on PATH) and refuses without ``DATA_PATH``; the JobSet
  manifest, read as text (the card's machine has no YAML parser), runs the
  script on 4 pods of 8 NVIDIA cards and holds no TPU key.
- Two copies of the script, each in its own working directory, as two
  nodes of 2 ranks through torchrun's c10d rendezvous on localhost (gloo,
  ``--device cpu``): MLP with FSDP2 over the 4 ranks, as JAX's job sets
  ``mesh.fsdp``. The agent that joins second holds ranks 2 and 3 with
  LOCAL_RANK 0 and 1, and which copy that is, is not fixed: both exit 0,
  exactly one result JSON is written, and its metrics equal one process's
  ``run_experiment`` of the same config within 1e-4.
- The card a rank takes is its LOCAL_RANK (``parallel/mesh.py::
  local_device``), not its global RANK modulo the cards: checked with
  ``torch.cuda.set_device`` and ``device_count`` patched, in
  ``initialize_distributed``, ``entry.py::_dryrun`` and
  ``dryrun_multichip`` joining a group of 2 nodes of 4 cards.
"""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from multi_modal_csi_tpu_torch import entry
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.parallel import mesh
from multi_modal_csi_tpu_torch.runners.csi import run_experiment
from test_torch_port_runner import dataset_overrides, write_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = os.path.join(REPO, "multi_modal_csi_tpu_torch", "jobs")
LAUNCHER = os.path.join(JOBS, "gpu-multinode.sh")
JOBSET = os.path.join(JOBS, "gpu-multinode-jobset.yaml")
JAX_JOBSET = os.path.join(REPO, "jobs", "tpu-multihost-jobset.yaml")
NODE_TIMEOUT = 120         # seconds for a copy of the launcher to finish
DRY_ENV = {"NNODES": "2", "NPROC_PER_NODE": "2", "MASTER_ADDR": "10.0.0.1",
           "MASTER_PORT": "29511", "RDZV_ID": "t",
           "DATA_PATH": "/tmp/wimans", "MODEL_TYPE": "THAT"}
# the launcher's own variables, which a test's environment must not leak
LAUNCHER_VARS = ("NNODES", "NPROC_PER_NODE", "MASTER_ADDR", "MASTER_PORT",
                 "RDZV_ID", "DATA_PATH", "MODEL_TYPE", "MAX_RESTARTS",
                 "MMCSI_NODE_STEP")


def clean_env(**extra):
    """This process's environment without pytest's, XLA's, SLURM's or the
    launcher's variables, this interpreter's ``python3`` first on PATH,
    then ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "PYTEST_", "SLURM_"))
           and k not in LAUNCHER_VARS}
    env["PATH"] = os.pathsep.join([os.path.dirname(sys.executable),
                                   env.get("PATH", "")])
    env.update(extra)
    return env


def launch(env, args=(), cwd=REPO):
    return subprocess.run(["bash", LAUNCHER, *args], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=60)


def dry_lines(r):
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("DRY ")]
    assert len(lines) == 1, r.stdout
    return lines[0]


def jax_run_csi(env):
    """The ``run_csi`` command of JAX's JobSet, expanded by bash under
    ``env``, from ``-m`` on, with the package renamed to the port's."""
    with open(JAX_JOBSET) as f:
        text = f.read()
    command = text[text.index("python -m multi_modal_csi_tpu.cli.run_csi"):
                   text.index("volumeMounts:")]
    r = subprocess.run(["bash", "-c", "echo " + command.split(" ", 1)[1]],
                       capture_output=True, text=True, env=env, timeout=60)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().replace("multi_modal_csi_tpu.",
                                    "multi_modal_csi_tpu_torch.")


# ---------------------------------------------------------------------- #
# (a) the dry run and the manifest
# ---------------------------------------------------------------------- #

def test_launcher_parses():
    r = subprocess.run(["bash", "-n", LAUNCHER], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr


def test_dry_run_is_one_torchrun_of_jax_flags():
    env = clean_env(DRY_RUN="1", **DRY_ENV)
    line = dry_lines(launch(env, ["--device", "cpu"]))
    want = jax_run_csi(env)
    assert want.startswith("-m multi_modal_csi_tpu_torch.cli.run_csi "
                           "--model THAT --task activity --distributed "
                           "--mesh --set mesh.fsdp=true --set path.data_x="
                           "/tmp/wimans/wifi_csi/amp --set path.data_y="
                           "/tmp/wimans/annotation.csv"), want
    assert line == (
        "DRY python3 -m torch.distributed.run --nnodes 2 --nproc-per-node 2 "
        "--rdzv-backend c10d --rdzv-endpoint 10.0.0.1:29511 --rdzv-id t "
        f"--max-restarts 3 {want} --device cpu")


def test_dry_run_under_slurm(tmp_path):
    """The rendezvous from SLURM's variables, the endpoint the first host
    that ``scontrol show hostnames`` gives for the job's node list; the
    environment's own values are ignored there."""
    stub = tmp_path / "scontrol"
    stub.write_text('#!/bin/sh\n'
                    '[ "$*" = "show hostnames gpu-[3-6]" ] || exit 3\n'
                    'printf "gpu-3\\ngpu-4\\ngpu-5\\ngpu-6\\n"\n')
    stub.chmod(0o755)
    env = clean_env(DRY_RUN="1", **DRY_ENV, SLURM_JOB_ID="7",
                    SLURM_NNODES="4", SLURM_GPUS_ON_NODE="8",
                    SLURM_JOB_NODELIST="gpu-[3-6]")
    env["PATH"] = os.pathsep.join([str(tmp_path), env["PATH"]])
    line = dry_lines(launch(env))
    assert ("--nnodes 4 --nproc-per-node 8 --rdzv-backend c10d "
            "--rdzv-endpoint gpu-3:29511 --rdzv-id 7 ") in line, line


def test_launcher_refuses_without_its_variables():
    r = launch(clean_env(DRY_RUN="1", **{k: v for k, v in DRY_ENV.items()
                                         if k != "DATA_PATH"}))
    assert r.returncode != 0 and "DATA_PATH" in r.stderr, r.stderr
    for name in ("NNODES", "NPROC_PER_NODE", "MASTER_ADDR", "RDZV_ID"):
        r = launch(clean_env(DRY_RUN="1", **{k: v for k, v in DRY_ENV.items()
                                             if k != name}))
        assert r.returncode != 0 and name in r.stderr, (name, r.stderr)
        assert "DRY " not in r.stdout


def test_jobset_manifest():
    with open(JOBSET) as f:
        text = f.read()
    for want in ('command: ["bash", '
                 '"multi_modal_csi_tpu_torch/jobs/gpu-multinode.sh"]',
                 'nvidia.com/gpu: "8"', "maxRestarts: 3", "parallelism: 4",
                 "value: mmcsi-train-workers-0-0.mmcsi-train",
                 "claimName: wimans-data", "kind: JobSet"):
        assert want in text, want
    for name, value in (("NNODES", "4"), ("NPROC_PER_NODE", "8")):
        assert f'- name: {name}\n                      value: "{value}"' \
            in text, name
    for tpu in ("google.com/tpu", "gke-tpu", "8471"):
        assert tpu not in text, tpu


# ---------------------------------------------------------------------- #
# (b) two nodes of two ranks through torchrun
# ---------------------------------------------------------------------- #

RUN = {"nn.epoch": 1, "nn.batch_size": 4, "path.save": "result.json"}


@pytest.fixture(scope="module")
def two_nodes(tmp_path_factory):
    """Both copies' exit codes and logs, their working directories, and
    the one-process result (the reference runs while they do)."""
    root = tmp_path_factory.mktemp("two_nodes")
    data = root / "wimans"
    write_dataset(data / "wifi_csi", n=40, seed=2)
    os.replace(data / "wifi_csi" / "annotation.csv", data / "annotation.csv")
    run = dict({k: v for k, v in dataset_overrides(data, length=60).items()
                if not k.startswith("path.")}, **RUN)
    args = ["--device", "cpu", "--repeat", "1"]
    for key, value in run.items():
        value = ",".join(value) if isinstance(value, list) else value
        args += ["--set", f"{key}={value}"]
    env = clean_env(NNODES="2", NPROC_PER_NODE="2", MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(mesh.free_port()), RDZV_ID="two-nodes",
                    DATA_PATH=str(data), MODEL_TYPE="MLP", MAX_RESTARTS="0",
                    OMP_NUM_THREADS="1")
    nodes = [root / f"node{i}" for i in range(2)]
    procs = []
    try:
        for where in nodes:
            where.mkdir()
            procs.append(subprocess.Popen(
                ["bash", LAUNCHER, *args], env=env, cwd=str(where),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True))
        cfg = Config().override(dict(
            run, model="MLP", task="activity", repeat=1,
            **{"mesh.fsdp": True,
               "path.data_x": str(data / "wifi_csi" / "amp"),
               "path.data_y": str(data / "annotation.csv"),
               "path.save": str(root / "one.json")}))
        run_experiment(cfg, device="cpu")
        with open(root / "one.json") as f:
            one = json.load(f)
        done = []
        for p in procs:
            log, _ = p.communicate(timeout=NODE_TIMEOUT)
            done.append((p.returncode, log))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the launcher did not finish in {NODE_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return done, nodes, one


def close(got, want, where="result"):
    """``got`` equals ``want`` key for key, every number within 1e-4
    relative; wall times (``time_*``) are not compared."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for key, value in want.items():
            if not key.startswith("time_"):
                close(got[key], value, f"{where}.{key}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (mine, theirs) in enumerate(zip(got, want)):
            close(mine, theirs, f"{where}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-4, abs=1e-12,
                                    nan_ok=True), where
    else:
        assert got == want, where


def test_two_nodes_exit_zero_and_write_one_result(two_nodes):
    done, nodes, _ = two_nodes
    for node, (rc, log) in enumerate(done):
        assert rc == 0, f"node {node} exited {rc}:\n{log[-4000:]}"
    written = [n for n in nodes if (n / "result.json").exists()]
    assert len(written) == 1, written
    printed = ["'accuracy'" in log for _, log in done]
    assert printed == [n in written for n in nodes], printed


def test_two_nodes_match_one_process(two_nodes):
    done, nodes, one = two_nodes
    assert all(rc == 0 for rc, _ in done)
    (path,) = [n / "result.json" for n in nodes
               if (n / "result.json").exists()]
    with open(path) as f:
        got = json.load(f)
    assert got["model"] == "MLP" and got["nn"]["batch_size"] == 4
    assert 0 <= got["accuracy"]["avg"] <= 100
    close(got, one)


# ---------------------------------------------------------------------- #
# (c) the card is LOCAL_RANK's
# ---------------------------------------------------------------------- #

class _Chosen(Exception):
    """Raised by the patched ``set_device``: the card is chosen, stop."""


@pytest.mark.parametrize("call, cards", [
    ("initialize_distributed", 8), ("_dryrun", 8),
    ("dryrun_multichip", 4)])
def test_card_chosen_by_local_rank(monkeypatch, call, cards):
    """Rank 5 of 8, the second of its node: card 1. On nodes of 8 cards
    the global rule would take card 5; on nodes of 4 ``dryrun_multichip``
    refused a world of 8 as more ranks than cards."""
    chosen = []

    def set_device(device):
        chosen.append(device if isinstance(device, int) else device.index)
        raise _Chosen

    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh, "_backend", lambda device: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    for name, value in (("RANK", "5"), ("LOCAL_RANK", "1"),
                        ("WORLD_SIZE", "8"), ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", "29500")):
        monkeypatch.setenv(name, value)
    with pytest.raises(_Chosen):
        if call == "initialize_distributed":
            mesh.initialize_distributed(device="cuda")
        elif call == "_dryrun":
            entry._dryrun(8, torch.device("cuda"))
        else:
            entry.dryrun_multichip(8, "cuda")
    assert chosen == [1]


def test_local_device_outside_torchrun(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.local_device() == 0
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_device() == 3
