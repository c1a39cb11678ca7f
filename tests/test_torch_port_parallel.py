"""The port's parallel layer (parallel/{mesh,collectives,partition}.py and
the global statistics and draws of nn/layers.py, train/augment.py and
losses/basic.py) on the CPU, against the JAX package and against one
process on the whole batch.

- ``fsdp_spec`` and ``fsdp_sharding_tree`` equal JAX's on a table of leaf
  shapes and meshes, and ``BatchSharding.rows`` JAX's ``_local_rows`` for
  every rank of every mesh of 8 devices (each device taken as one rank's
  process);
- ``initialize_distributed`` does nothing without torchrun's environment
  or for ``num_processes=1``, and ``--mesh`` (``use_mesh``) in a process
  that torchrun started as one of 2 but that joined no group raises,
  rather than training alone on the whole data set;
- one 2-rank gloo group (two processes started with torchrun's
  environment, ``initialize_distributed(device="cpu")``) runs, inside
  ``axis_scope`` of a ("data", "model") = (2, 1) mesh:
  ``gather_from_all`` (values, and each rank's gradient the sum of both
  ranks'), ``info_nce`` with the gather (every rank's loss, and its input
  gradients divided by the data axis's size, equal to JAX's full-batch
  ``info_nce`` and its gradient), the global ``BatchNorm`` (output, input
  gradient, the weight gradients summed over the ranks, the running
  statistics: equal to one process on the whole batch), the dropout,
  drop-path and augmentation draws (each rank's equal to its rows of one
  process's), the weighted cross-entropy's global denominator (the mean
  over ranks equal to the whole batch's loss, the gradient as for
  InfoNCE), ``psum``/``pmean``, and ``batch_sharding``/``shard_batch`` on
  (2, 1) and (1, 2) meshes.

The ranks' processes import this module (no JAX in them); the JAX side
runs in the pytest process. Each spawn is bounded by a timeout that kills
its ranks.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch.parallel.mesh import BatchSharding
from multi_modal_csi_tpu_torch.parallel.partition import (fsdp_sharding_tree,
                                                          fsdp_spec)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANKS = 2
SPAWN_TIMEOUT = 240        # seconds for a group's ranks to finish

_RANK_SCRIPT = textwrap.dedent("""
    import sys
    sys.path[:0] = [{tests!r}, {repo!r}]
    import torch
    torch.set_num_threads(1)
    import {module} as m
    m.rank_main({func!r}, {out!r}, {kwargs!r}, {join!r})
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module, func, tmp_path, ranks=RANKS, kwargs=None,
                join=True):
    """Start ``ranks`` processes with torchrun's environment on a free
    port: each runs ``module.func(rank, ranks, **kwargs)`` (``rank_main``)
    and saves its result, in a gloo group that it joins first, or, with
    ``join`` False, that ``func`` joins."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "PYTEST_"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(ranks), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
    procs = []
    cmd = [sys.executable, "-c", _RANK_SCRIPT.format(
        tests=TESTS, repo=REPO, module=module, func=func, out=str(tmp_path),
        kwargs=kwargs or {}, join=join)]
    for rank in range(ranks):
        procs.append(subprocess.Popen(
            cmd, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def join_ranks(procs, tmp_path, timeout=SPAWN_TIMEOUT):
    """Wait for the ranks of ``start_ranks`` and return their saved
    results; every rank is killed when one fails or the timeout
    passes."""
    logs = []
    try:
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=timeout)
            logs.append(log)
            assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {len(procs)} ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def rank_main(func, out, kwargs, join=True):
    """A rank's body: join the group from torchrun's environment (or let
    ``func`` join it), run ``func`` of the calling module, save its
    result, leave the group."""
    import torch.distributed as dist
    from multi_modal_csi_tpu_torch.parallel.mesh import initialize_distributed
    if join:
        initialize_distributed(device="cpu")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    module = sys.modules[func.rsplit(":", 1)[0]]
    result = getattr(module, func.rsplit(":", 1)[1])(rank, world, **kwargs)
    assert "jax" not in sys.modules, "a rank loaded JAX"
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# the rules against JAX's, no process group
# ---------------------------------------------------------------------- #

MESHES = [{"data": 8, "model": 1}, {"data": 4, "model": 2},
          {"data": 2, "model": 4}, {"data": 1, "model": 8}]
SHAPES = [(256, 256), (16,), (16384,), (16383,), (3000, 270), (270, 810),
          (512, 270, 15), (54,), (128, 64, 3), (7, 7, 7, 3, 96),
          (1000, 17), (96, 3, 7, 7), (400, 768), (3, 5461)]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a['data']}x"
                         f"{a['model']}")
def test_fsdp_spec_and_local_rows_match_jax(axes):
    import jax
    from multi_modal_csi_tpu.data import pipeline as jax_pipeline
    from multi_modal_csi_tpu.parallel import mesh as jax_mesh
    from multi_modal_csi_tpu.parallel import partition as jax_partition

    mesh = jax_mesh.create_mesh(dict(axes), devices=jax.devices()[:8])
    for shape in SHAPES:
        for min_size in (jax_partition.FSDP_MIN_SIZE, 1):
            want = jax_partition.fsdp_spec(shape, mesh, min_size=min_size)
            got = fsdp_spec(shape, axes, min_size=min_size)
            assert got == tuple(want), (shape, min_size, got, want)
    tree = {str(shape): np.zeros(shape, np.int8) for shape in SHAPES}
    want = jax_partition.fsdp_sharding_tree(tree, mesh)
    assert fsdp_sharding_tree(tree, axes) == {
        name: tuple(sharding.spec) for name, sharding in want.items()}

    class OneDevice:
        """JAX's sharding as the process of one device sees it."""

        def __init__(self, sharding, device):
            self.sharding, self.device = sharding, device

        def addressable_devices_indices_map(self, shape):
            return {self.device:
                    self.sharding.devices_indices_map(shape)[self.device]}

    devices = mesh.devices.reshape(-1)          # rank r: row-major
    for batch in (8, 16, 24):
        shape = (batch, 3000, 270)
        sharding = jax_mesh.batch_sharding(mesh, len(shape))
        for rank, device in enumerate(devices):
            want = jax_pipeline._local_rows(OneDevice(sharding, device),
                                            shape)
            mine = BatchSharding(None, axes["data"], rank // axes["model"])
            rows = mine.rows(batch)
            assert (rows.start, rows.stop) == want, (rank, batch)
    with pytest.raises(ValueError, match="does not split"):
        BatchSharding(None, 4, 0).rows(6)


def test_collectives_are_the_identity_outside_a_scope():
    from multi_modal_csi_tpu_torch.parallel import collectives as C
    x = torch.arange(6.0).reshape(3, 2)
    for fn in (C.psum, C.pmean, C.gather_from_all, C.local_rows):
        assert fn(x) is x
    assert C.global_rows((3, 2)) == (3, 2)
    assert not C.axis_present("data")
    assert C.axis_size() == 1 and C.axis_index() == 0


@pytest.mark.parametrize("cli", ["run_csi", "run_video"])
def test_mesh_without_a_group_under_torchrun_raises(cli, monkeypatch):
    import importlib
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.parallel.mesh import config_batch_sharding
    import torch.distributed as dist
    from multi_modal_csi_tpu_torch.parallel.mesh import initialize_distributed
    main = importlib.import_module(
        f"multi_modal_csi_tpu_torch.cli.{cli}").main
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    initialize_distributed(device="cpu")        # no torchrun: nothing
    assert config_batch_sharding(Config(), "cpu") is None   # one process
    for name, value in (("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(_free_port())),
                        ("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    initialize_distributed(1, device="cpu")     # one process: nothing
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group was joined"):
        main(["--mesh", "--device", "cpu", "--model", "MLP" if
              cli == "run_csi" else "ResNet"])


# ---------------------------------------------------------------------- #
# 2 ranks against one process on the whole batch
# ---------------------------------------------------------------------- #

ROWS = 4                   # a rank's rows; the global batch is 2 x 4


def global_inputs():
    rng = np.random.default_rng(7)
    n = RANKS * ROWS
    return {
        "x": rng.standard_normal((n, 3)).astype(np.float32),
        "w": rng.standard_normal((n, 3)).astype(np.float32),
        "z1": rng.standard_normal((n, 8)).astype(np.float32),
        "z2": rng.standard_normal((n, 8)).astype(np.float32),
        "xb": rng.standard_normal((n, 5, 6)).astype(np.float32) * 2 + 1,
        "wb": rng.standard_normal((n, 5, 6)).astype(np.float32),
        "gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
        "beta": rng.standard_normal(6).astype(np.float32),
        "logits": rng.standard_normal((n, 10)).astype(np.float32),
        "targets": rng.integers(0, 10, n),
        "class_w": rng.uniform(0.25, 2.0, 10).astype(np.float32),
    }


def batch_norm(data, rows):
    """The port's BatchNorm in training mode on ``rows`` of the inputs:
    (module, input, output) after the backward of sum(y * wb)."""
    from multi_modal_csi_tpu_torch.nn.layers import BatchNorm
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(data["gamma"]))
        bn.bias.copy_(torch.from_numpy(data["beta"]))
    x = torch.tensor(data["xb"][rows], requires_grad=True)
    y = bn(x)
    (y * torch.from_numpy(data["wb"][rows])).sum().backward()
    return bn, x, y


def draws(shape_rows):
    """Dropout, drop-path and augmentation draws from one seeded
    generator on ones of ``shape_rows`` rows."""
    from multi_modal_csi_tpu_torch.nn.layers import (DropPath, Dropout,
                                                     dropout_generator)
    from multi_modal_csi_tpu_torch.train.augment import apply_augmentation
    gen = torch.Generator().manual_seed(5)
    ones = torch.ones(shape_rows, 4, 3)
    with dropout_generator(gen):
        drop = Dropout(0.5).train()(ones)
        path = DropPath(0.5).train()(ones)
    return {"dropout": drop, "drop_path": path,
            "augment": apply_augmentation(ones, gen)}


def weighted_ce(data, rows):
    from multi_modal_csi_tpu_torch.losses.basic import cross_entropy
    logits = torch.tensor(data["logits"][rows], requires_grad=True)
    loss = cross_entropy(logits, torch.from_numpy(data["targets"][rows]),
                         weight=torch.from_numpy(data["class_w"]),
                         label_smoothing=0.1)
    loss.backward()
    return loss.detach(), logits.grad


def collectives_rank(rank, world):
    """Every collective check of one rank (module docstring)."""
    from multi_modal_csi_tpu_torch.models.csi.ssl import info_nce
    from multi_modal_csi_tpu_torch.parallel import collectives as C
    from multi_modal_csi_tpu_torch.parallel.mesh import (batch_sharding,
                                                         create_mesh,
                                                         shard_batch)
    data = global_inputs()
    rows = slice(rank * ROWS, (rank + 1) * ROWS)
    mesh = create_mesh({"data": world, "model": 1})
    replicated = create_mesh({"data": 1, "model": world})
    sharding, other = batch_sharding(mesh), batch_sharding(replicated)
    res = {"sharding": (sharding.size, sharding.index),
           "replicated": (other.size, other.index),
           "shard_batch": shard_batch(sharding, np.arange(2 * world)),
           "shard_index": shard_batch(sharding, np.arange(4 * world)
                                      .reshape(2, 2 * world), axis=1)}
    with C.axis_scope(mesh):
        x = torch.tensor(data["x"][rows], requires_grad=True)
        gathered = C.gather_from_all(x)
        (gathered * torch.from_numpy(data["w"])).sum().backward()
        res.update(gathered=gathered.detach(), gather_grad=x.grad)

        a = torch.tensor(data["z1"][rows], requires_grad=True)
        b = torch.tensor(data["z2"][rows], requires_grad=True)
        loss = info_nce(a, b, gather_axis="data")
        loss.backward()
        res.update(nce=loss.detach(), nce_a=a.grad, nce_b=b.grad)

        bn, xb, y = batch_norm(data, rows)
        res.update(bn_y=y.detach(), bn_x=xb.grad, bn_w=bn.weight.grad,
                   bn_b=bn.bias.grad, bn_mean=bn.running_mean,
                   bn_var=bn.running_var)
        res.update(draws(ROWS))
        res["ce"], res["ce_grad"] = weighted_ce(data, rows)
        res["psum"] = C.psum(torch.tensor([rank + 1.0]))
        res["pmean"] = C.pmean(torch.tensor([rank + 1.0]))
    return res


def test_collectives_at_two_ranks(tmp_path):
    import jax
    import jax.numpy as jnp
    from multi_modal_csi_tpu.losses.basic import cross_entropy as jax_ce
    from multi_modal_csi_tpu.models.csi.ssl import info_nce as jax_info_nce

    procs = start_ranks("test_torch_port_parallel",
                        "test_torch_port_parallel:collectives_rank", tmp_path)
    try:                               # the references, while they run
        data = global_inputs()
        everything = slice(None)
        bn, xb, y = batch_norm(data, everything)
        whole = draws(RANKS * ROWS)
        want_nce, (grad_a, grad_b) = jax.value_and_grad(
            jax_info_nce, argnums=(0, 1))(jnp.asarray(data["z1"]),
                                          jnp.asarray(data["z2"]))
        want_ce = jax_ce(jnp.asarray(data["logits"]),
                         jnp.asarray(data["targets"]),
                         weight=jnp.asarray(data["class_w"]),
                         label_smoothing=0.1)
        ce, ce_grad = weighted_ce(data, everything)
    finally:
        ranks = join_ranks(procs, tmp_path)
    assert float(ce) == pytest.approx(float(want_ce), rel=1e-6)

    for rank, res in enumerate(ranks):
        rows = slice(rank * ROWS, (rank + 1) * ROWS)
        assert res["sharding"] == (RANKS, rank)
        assert res["replicated"] == (1, 0)
        np.testing.assert_array_equal(res["shard_batch"],
                                      np.arange(4)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(
            res["shard_index"],
            np.arange(8).reshape(2, 4)[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(res["gathered"].numpy(), data["x"])
        np.testing.assert_allclose(res["gather_grad"].numpy(),
                                   RANKS * data["w"][rows], rtol=1e-6)
        # InfoNCE: every rank the global loss; the gradient after the
        # step's average over the ranks is the full batch's
        assert float(res["nce"]) == pytest.approx(float(want_nce), rel=1e-5)
        for got, want in ((res["nce_a"], grad_a), (res["nce_b"], grad_b)):
            np.testing.assert_allclose(got.numpy() / RANKS,
                                       np.asarray(want)[rows], rtol=1e-4,
                                       atol=1e-6)
        np.testing.assert_allclose(res["bn_y"].numpy(),
                                   y.detach().numpy()[rows], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["bn_x"].numpy(),
                                   xb.grad.numpy()[rows], rtol=1e-4,
                                   atol=1e-5)
        for name, want in (("bn_mean", bn.running_mean),
                           ("bn_var", bn.running_var)):
            np.testing.assert_allclose(res[name].numpy(), want.numpy(),
                                       rtol=1e-5, err_msg=name)
        for name in ("dropout", "drop_path", "augment"):
            np.testing.assert_array_equal(res[name].numpy(),
                                          whole[name].numpy()[rows],
                                          err_msg=name)
        np.testing.assert_allclose(res["ce_grad"].numpy() / RANKS,
                                   ce_grad.numpy()[rows], rtol=1e-5,
                                   atol=1e-7)
        assert float(res["psum"]) == 3.0 and float(res["pmean"]) == 1.5
    # the weight gradients and the loss: each rank holds its term
    for name, want in (("bn_w", bn.weight.grad), ("bn_b", bn.bias.grad)):
        np.testing.assert_allclose(sum(r[name] for r in ranks).numpy(),
                                   want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(sum(r["ce"] for r in ranks)) / RANKS == pytest.approx(
        float(ce), rel=1e-6)
