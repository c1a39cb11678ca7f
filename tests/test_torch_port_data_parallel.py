"""The port's data-parallel training (train/loop.py::fit and
runners/video.py::fit_video with ``sharding`` and ``fsdp``,
runners/csi.py's ``use_mesh`` and cli/run_csi.py's ``--distributed
--mesh``) at 2 ranks on the CPU (gloo), against the JAX package's sharded
runs and against the port's own single process.

One group of 2 ranks, started once for the module (``two_ranks``) with
torchrun's environment, runs everything below; the references run in the
pytest process while the ranks run, and each test checks its part.

- ``cli/run_csi.py --distributed --mesh --device cpu`` for MLP, called
  first, so the CLI itself joins the group torchrun describes: only rank
  0 prints the result and writes the JSON;
- ``fit`` for CNN-2D (its input and head BatchNorms, dropout 0.2) at
  (251, 251) windows, 12 training and 10 validation windows, batch 4 (2
  rows a rank), from the weights of test_torch_port_csi_baselines.py:
  - dropout off, augmentation off, lr 5e-5, 2 epochs, with and without
    ``fsdp``, against JAX's ``fit(sharding=...)`` on a 2-device mesh of
    the same weights, with test_torch_port_fit.py's harness and bounds:
    the training and validation losses within 1e-4 relative, the discrete
    metrics equal, the same best epoch;
  - dropout and augmentation on, 3 epochs, with and without ``fsdp``,
    against the port's ``fit`` in one process: every number of the
    history within 1e-4 relative (JAX's tests/test_data_parallel.py holds
    its sharded fit so), the best weights within Adam's 2 lr a step;
  - the ``fsdp`` run's checkpoint holds whole tensors, the state dicts of
    an unsharded run, and resuming from it at 2 ranks under ``fsdp``
    trains the next epoch as one process resuming from it does;
- ``fit_video`` on a tiny model with a BatchNorm (flatten, Dense 16
  without a bias, BatchNorm, ReLU, Dense 2, defined here on both sides as
  test_torch_port_video_fit.py defines its tiny model; a bias before the
  BatchNorm would get a gradient of rounding noise only, which Adam turns
  into steps of lr in a direction that the order of a sum decides), with
  and without
  ``fsdp``, against JAX's ``fit_video`` with a 2-device batch sharding
  from the same weights: 18 training clips of (2, 4, 4) (4 batches of 4,
  2 rows a rank) and a 5-clip test set the ranks do not divide, 2
  epochs; per epoch the last batch's loss within 1e-5 relative and the
  accuracies equal, then the best accuracy equal and the best weights
  (the BatchNorm's global running statistics included) within 1e-5;
- ``run_csi_model(use_mesh=True)`` for MLP at 2 ranks, with and without
  ``mesh.fsdp``, against one process: every metric within 1e-4 (the
  runner's augmentation draws from torch's generator, so no JAX run
  draws the same).

The ranks import this module (no JAX in them) and read their inputs from
a file the references' side writes.
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

from test_torch_port_parallel import (join_ranks, rank_main,  # noqa: F401
                                      start_ranks)

torch.set_num_threads(1)

KEY, OUT, WINDOW = "CNN-2D", 54, (251, 251)
FIT = dict(mode="baseline", lr=5e-5, epochs=2, batch_size=4, seed=0,
           weight_decay=2e-4, augment=False)
DROPOUT_FIT = dict(FIT, epochs=3, augment=True)
ADAM_DRIFT = 2 * FIT["lr"] * 2 * 3       # 2 lr a step, 6 steps
TINY_CLIP = (2, 4, 4)
TINY_FIT = dict(lr=1e-2, epochs=2, batch_size=4, seed=0, threshold=0.5,
                verbose=False, num_workers=1)
MLP_RUN = {"model": "MLP", "repeat": 1, "nn.epoch": 2, "nn.batch_size": 4}
MODULE = "test_torch_port_data_parallel"


class _NoDropout:
    """Stands in for flax.linen.Dropout: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def cnn2d(state, dropout):
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.nn.layers import Dropout
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS
    model = CSI_MODELS[KEY].build(WINDOW, OUT, Config(),
                                  torch.Generator().manual_seed(0))
    model.load_state_dict(state, strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def cnn2d_fit(inp, dropout, settings, **kwargs):
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import CSI_MODELS
    from multi_modal_csi_tpu_torch.train.loop import fit
    return fit(cnn2d(inp["state"], dropout), *inp["fit_data"],
               loss_fn=CSI_MODELS[KEY].make_loss(Config(), OUT),
               device="cpu", **settings, **kwargs)


class TinyBN(nn.Module):
    """Flatten, Dense 16 without a bias, the port's BatchNorm, ReLU,
    Dense 2: the counterpart of ``jax_tiny_bn``'s model, on its
    weights."""

    def __init__(self, state):
        from multi_modal_csi_tpu_torch.nn.layers import BatchNorm
        super().__init__()
        self.hidden = nn.Linear(int(np.prod(TINY_CLIP)) * 3, 16,
                                bias=False)
        self.norm = BatchNorm(16)
        self.out = nn.Linear(16, 2)
        self.load_state_dict(state, strict=True)

    def forward(self, x):
        h = self.norm(self.hidden(x.reshape(x.shape[0], -1)))
        return self.out(torch.relu(h))


def jax_tiny_bn():
    """The JAX side of ``TinyBN`` (built here: the ranks import no
    JAX)."""
    import flax.linen as fnn
    from multi_modal_csi_tpu.nn.layers import BatchNorm

    class JaxTinyBN(fnn.Module):
        @fnn.compact
        def __call__(self, x, train: bool = False):
            h = fnn.Dense(16, use_bias=False, name="hidden")(
                x.reshape(x.shape[0], -1))
            h = BatchNorm(name="norm")(h, use_running_average=not train)
            return fnn.Dense(2, name="out")(fnn.relu(h))

    return JaxTinyBN()


def tiny_state(params, stats):
    """``TinyBN``'s state dict from the JAX model's variables."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    return {"hidden.weight": t(params["hidden"]["kernel"]).T,
            "norm.weight": t(params["norm"]["bn"]["scale"]),
            "norm.bias": t(params["norm"]["bn"]["bias"]),
            "norm.running_mean": t(stats["norm"]["bn"]["mean"]),
            "norm.running_var": t(stats["norm"]["bn"]["var"]),
            "out.weight": t(params["out"]["kernel"]).T,
            "out.bias": t(params["out"]["bias"])}


def tiny_clips(n, seed):
    """(2, 4, 4) clips whose two labels are the signs of two channel
    means (test_torch_port_video_fit.py's)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *TINY_CLIP, 3), dtype=np.float32)
    y = np.stack([x[..., 0].mean(axis=(1, 2, 3)) > 0,
                  x[..., 1].mean(axis=(1, 2, 3)) > 0], axis=1)
    return x, y.astype(np.float32)


def tiny_fit(inp, **kwargs):
    from multi_modal_csi_tpu_torch.data.video_io import ArrayClips
    from multi_modal_csi_tpu_torch.runners.video import fit_video
    x_tr, y_tr, x_te, y_te = inp["tiny_data"]
    history = []
    best, acc = fit_video(TinyBN(inp["tiny_state"]), ArrayClips(x_tr, y_tr),
                          ArrayClips(x_te, y_te), history=history,
                          device="cpu", **TINY_FIT, **kwargs)
    return history, best, acc


def mlp_run(inp, use_mesh, fsdp):
    from multi_modal_csi_tpu_torch.core.config import Config
    from multi_modal_csi_tpu_torch.runners.csi import run_csi_model
    cfg = Config().override(dict(MLP_RUN, **{"mesh.fsdp": fsdp}))
    return run_csi_model(cfg, inp["mlp_data"], use_mesh=use_mesh,
                         device="cpu")


def cli_run(root, rank, argv):
    """``cli/run_csi.py``'s main with ``argv``, in ``root/rank<rank>``:
    what it printed."""
    from multi_modal_csi_tpu_torch.cli import run_csi
    where = os.path.join(root, f"rank{rank}")
    os.makedirs(where, exist_ok=True)
    here, printed = os.getcwd(), io.StringIO()
    os.chdir(where)
    try:
        with contextlib.redirect_stdout(printed):
            run_csi.main(argv)
    finally:
        os.chdir(here)
    return printed.getvalue()


def training_rank(rank, world, root, cli_argv):
    """Every 2-rank run of this file (module docstring)."""
    from multi_modal_csi_tpu_torch.parallel.mesh import (barrier,
                                                         batch_sharding,
                                                         create_mesh)
    res = {"cli": cli_run(root, rank, cli_argv)}     # joins the group
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    sharding = batch_sharding(create_mesh({"data": world, "model": 1}))
    ckpt = os.path.join(root, "ckpt")
    for fsdp in (False, True):
        run = cnn2d_fit(inp, False, FIT, sharding=sharding, fsdp=fsdp,
                        checkpoint_dir=ckpt if fsdp else None,
                        checkpoint_every=1)
        res[f"jax_{fsdp}"] = (run.history, run.best_epoch)
    if rank == 0:                      # the checkpoint one process resumes
        shutil.copytree(ckpt, os.path.join(root, "ckpt_one"))
    barrier()
    resumed = cnn2d_fit(inp, False, dict(FIT, epochs=3), sharding=sharding,
                        fsdp=True, checkpoint_dir=ckpt, checkpoint_every=1)
    res["resumed"] = resumed.history
    for fsdp in (False, True):
        run = cnn2d_fit(inp, True, DROPOUT_FIT, sharding=sharding,
                        fsdp=fsdp)
        res[f"dropout_{fsdp}"] = (run.history, run.best_state)
        res[f"tiny_{fsdp}"] = tiny_fit(inp, sharding=sharding, fsdp=fsdp)
    res["mlp"] = [mlp_run(inp, True, fsdp) for fsdp in (False, True)]
    return res


def write_inputs(root):
    """The CNN-2D weights and windows, the tiny model's weights and clips
    and the MLP run's data, for the ranks and the references; also the
    JAX models and variables."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_csi_baselines import pair
    from test_torch_port_csi_baselines_fit import raw_data
    from test_torch_port_csi_baselines_train import labelled
    from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
    jmodel, variables, _ = pair(KEY)
    tiny = jax_tiny_bn()
    (x_tr, y_tr), (x_te, y_te) = tiny_clips(18, 1), tiny_clips(5, 2)
    tiny_vars = jax.tree_util.tree_map(np.asarray, tiny.init(
        jax.random.PRNGKey(0), jnp.asarray(x_tr[:1])))
    inp = {"state": state_dict_from_jax(KEY, variables),
           "fit_data": labelled(KEY, 12, seed=3) + labelled(KEY, 10, seed=4),
           "tiny_state": tiny_state(tiny_vars["params"],
                                    tiny_vars["batch_stats"]),
           "tiny_data": (x_tr, y_tr, x_te, y_te),
           "mlp_data": raw_data((60, 20))}
    torch.save(inp, root / "inputs.pt")
    return (jmodel, variables), (tiny, tiny_vars), inp


def cli_argv(root):
    """The CLI's arguments on a small dataset written under ``root``."""
    from test_torch_port_runner import dataset_overrides, write_dataset
    write_dataset(root, n=40, seed=2)
    args = ["--distributed", "--mesh", "--device", "cpu", "--model", "MLP",
            "--repeat", "1"]
    for key, value in dict(dataset_overrides(root, length=60), **{
            "path.save": "result.json", "nn.epoch": 1,
            "nn.batch_size": 4}).items():
        value = ",".join(value) if isinstance(value, list) else value
        args += ["--set", f"{key}={value}"]
    return args


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The ranks' results and the references (module docstring)."""
    import jax
    import flax.linen
    from multi_modal_csi_tpu.data.video_io import ArrayClips as JaxClips
    from multi_modal_csi_tpu.parallel.mesh import batch_sharding, create_mesh
    from multi_modal_csi_tpu.runners.video import fit_video as jax_fit_video
    from multi_modal_csi_tpu.train.loop import fit as jax_fit
    from test_torch_port_csi_baselines_train import losses

    root = tmp_path_factory.mktemp("two_ranks")
    (jmodel, variables), (tiny, tiny_vars), inp = write_inputs(root)
    procs = start_ranks(MODULE, f"{MODULE}:training_rank", root, join=False,
                        kwargs={"root": str(root),
                                "cli_argv": cli_argv(root)})
    ref = {}
    try:                               # the references, while they run
        sharding = batch_sharding(create_mesh(
            {"data": 2, "model": 1}, devices=jax.devices()[:2]), 1)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "Dropout", _NoDropout)
            ref["jax"] = jax_fit(jmodel, *inp["fit_data"],
                                 loss_fn=losses(KEY)[0],
                                 init_variables=(variables["params"],
                                                 variables["batch_stats"]),
                                 sharding=sharding, **FIT)
        x_tr, y_tr, x_te, y_te = inp["tiny_data"]
        history = []
        (params, stats), acc = jax_fit_video(
            tiny, JaxClips(x_tr, y_tr), JaxClips(x_te, y_te),
            init_variables=(tiny_vars["params"], tiny_vars["batch_stats"]),
            history=history, sharding=sharding, **TINY_FIT)
        ref["tiny"] = (history, tiny_state(params, stats), acc)
        ref["one"] = cnn2d_fit(inp, True, DROPOUT_FIT)
        ref["mlp"] = mlp_run(inp, False, False)
    finally:
        ranks = join_ranks(procs, root)
    ref["one_resumed"] = cnn2d_fit(inp, False, dict(FIT, epochs=3),
                                   checkpoint_dir=str(root / "ckpt_one"),
                                   checkpoint_every=1)
    ref["saved"] = torch.load(root / "ckpt_one" / "step_1.pt",
                              weights_only=False)
    return root, inp, ranks, ref


def close_history(got, want, rel=1e-4):
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        for name, value in theirs.items():
            if name != "epoch_time":
                assert mine[name] == pytest.approx(value, rel=rel,
                                                   abs=1e-12), name


def close_results(got, want):
    for name, value in want.items():
        if name.startswith("time_"):
            continue
        if isinstance(value, dict):
            close_results(got[name], value)
        elif isinstance(value, (int, float)):
            assert got[name] == pytest.approx(value, rel=1e-4), name
        else:
            np.testing.assert_allclose(np.asarray(got[name], float),
                                       np.asarray(value, float), rtol=1e-4)


def test_data_parallel_training_at_two_ranks(two_ranks):
    """``fit`` with and without fsdp: against JAX's sharded fit (dropout
    and augmentation off), against one process (both on)."""
    _, _, ranks, ref = two_ranks
    want, one = ref["jax"], ref["one"]
    for res in ranks:
        for fsdp in (False, True):
            history, best_epoch = res[f"jax_{fsdp}"]
            assert best_epoch == want.best_epoch
            assert len(history) == len(want.history) == 2
            for mine, theirs in zip(history, want.history):
                for name in ("train_loss", "test_loss"):
                    assert mine[name] == pytest.approx(theirs[name],
                                                       rel=1e-4), name
                for name in ("perfect_prediction_percentage_test",
                             "perfect_prediction_percentage_train",
                             "total_error_test", "f1_score"):
                    assert mine[name] == theirs[name], name
            history, best = res[f"dropout_{fsdp}"]
            close_history(history, one.history)
            assert best.keys() == one.best_state.keys()
            for name, value in one.best_state.items():
                np.testing.assert_allclose(best[name], value, rtol=0,
                                           atol=ADAM_DRIFT, err_msg=name)


def test_fsdp_checkpoint_and_resume_at_two_ranks(two_ranks):
    """The fsdp run's checkpoint holds an unsharded run's state dicts, and
    resuming from it at 2 ranks trains as one process does."""
    _, inp, ranks, ref = two_ranks
    for res in ranks:
        close_history(res["resumed"], ref["one_resumed"].history)
        assert [h["epoch"] for h in res["resumed"]] == [2]
    saved = ref["saved"]
    model = cnn2d(inp["state"], False)
    assert {k: v.shape for k, v in saved["model"].items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    params = list(model.parameters())
    assert len(saved["optimizer"]["state"]) == len(params)
    for i, per in saved["optimizer"]["state"].items():
        assert type(per["exp_avg"]) is torch.Tensor
        assert per["exp_avg"].shape == params[i].shape


def test_fit_video_at_two_ranks_matches_jax_sharded(two_ranks):
    """The tiny BatchNorm model's ``fit_video``, with and without fsdp,
    against JAX's on a 2-device batch sharding (5 test clips)."""
    _, _, ranks, ref = two_ranks
    want_history, want_best, want_acc = ref["tiny"]
    assert want_acc > 0
    for res in ranks:
        for fsdp in (False, True):
            history, best, acc = res[f"tiny_{fsdp}"]
            assert len(history) == len(want_history) == 2
            for mine, theirs in zip(history, want_history):
                assert mine["epoch"] == theirs["epoch"]
                assert mine["train_loss"] == pytest.approx(
                    theirs["train_loss"], rel=1e-5)
                assert mine["train_acc"] == theirs["train_acc"]
                assert mine["test_acc"] == theirs["test_acc"]
            assert acc == want_acc
            assert best.keys() == want_best.keys()
            for name, value in want_best.items():
                np.testing.assert_allclose(best[name].numpy(),
                                           value.numpy(), atol=1e-5,
                                           err_msg=name)


def test_run_csi_model_use_mesh_at_two_ranks(two_ranks):
    """``run_csi_model(use_mesh=True)``, with and without mesh.fsdp,
    against one process."""
    _, _, ranks, ref = two_ranks
    for res in ranks:
        for got in res["mlp"]:
            close_results(got, ref["mlp"])


def test_run_csi_cli_distributed_mesh(two_ranks):
    """The CLI joined the group itself; only rank 0 printed and wrote."""
    root, _, ranks, _ = two_ranks
    assert "'accuracy'" in ranks[0]["cli"]
    assert "'accuracy'" not in ranks[1]["cli"]
    written = json.loads((root / "rank0" / "result.json").read_text())
    assert written["model"] == "MLP" and 0 <= written["accuracy"]["avg"]
    assert not os.path.exists(root / "rank1" / "result.json")
