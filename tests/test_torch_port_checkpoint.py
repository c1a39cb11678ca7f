"""The port's checkpoints and transfer learning (core/checkpoint.py,
train/transfer.py, the runners' save and restore, cli/inspect_model.py)
against the JAX package's, on the CPU, at the narrow shapes of
test_torch_port_runner.py: DETR at (300, 30) and THAT_ENCODER at
(1280, 90), 2 decoder layers.

- A reference ``.pt`` as the reference's own scripts write it (the
  ``model_state_dict`` wrapper, ``module._orig_mod.`` prefixes,
  BatchNorm's ``num_batches_tracked``, the Gaussian ``var_position`` and
  DETR's unused decoder LayerNorm) loads in both packages to the same
  logits (1e-6).
- A component file the port writes restores in JAX's ``restore_scenario``
  under each scenario, the tree equal leaf for leaf to what the scenario
  takes from the file and from the live weights; a JAX ``save_components``
  msgpack restores in the port to JAX's logits (1e-6), also under a
  ``.pt`` name, and a bf16 one to its values exactly.
- ``transfer_optimizer``: one update from the same gradients equals
  JAX's ``transfer_optimizer`` update within 1e-7 in each scenario, the
  frozen parameters bit for bit; a training step under
  ``feature_encoder`` updates the frozen feature extractor's BatchNorm
  statistics as JAX's training forward does (1e-5 relative).
- The video runner's warm start and save through ``path.save_model``.

test_torch_port_transfer_runs.py holds the runs: the CSI runner's save
and transfer, ``fit``'s resume, and ``cli/inspect_model.py``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core import checkpoint as jax_ckpt
from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.runners import csi as jax_runner
from multi_modal_csi_tpu.train.transfer import (
    transfer_optimizer as jax_transfer_optimizer)
from multi_modal_csi_tpu_torch.core import checkpoint
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.runners import csi as runner
from multi_modal_csi_tpu_torch.runners.video import run_video_model
from multi_modal_csi_tpu_torch.train.transfer import transfer_optimizer
from test_torch_port_layers import gen
from test_torch_port_runner import NARROW, perturbed, set_data
from test_torch_port_train_step import no_dropout, no_jax_dropout  # noqa: F401

torch.set_num_threads(1)

OVERRIDES = {"repeat": 1, "nn.batch_size": 4, "nn.num_decoder_layers": 2,
             "nn.dim_ffn": 64}
SCENARIOS = ("full", "feature_extractor", "feature_encoder")


def port_model(key, seed, shape=None, out=10):
    cfg = Config().override(dict(OVERRIDES, model=key))
    return perturbed(runner.CSI_MODELS[key].build(
        shape or NARROW[key], out, cfg, gen(seed)), seed)


def jax_tree(key, model, shape=None, out=10):
    """The JAX model of ``key`` and a copy of the port model's weights as
    its numpy variables."""
    jmodel = jax_runner.CSI_MODELS[key].build(
        shape or NARROW[key], out, JaxConfig().override(
            dict(OVERRIDES, model=key)))
    x = np.zeros((1,) + (shape or NARROW[key]), np.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, x, train=False))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return jmodel, import_state_dict(key, state, shapes)


def write_narrow_dataset(root, n=30, seed=0, channels=30, steps=(240, 320)):
    """annotation.csv under ``root`` (test_torch_port_data.py's, two bands
    and three environments) and one (T, channels) amplitude file per label
    under ``root/amp``; returns the config overrides that read them at
    length 300."""
    import csv
    from test_torch_port_data import write_annotation
    os.makedirs(root / "amp", exist_ok=True)
    write_annotation(str(root / "annotation.csv"), n=n, seed=seed)
    rng = np.random.default_rng(seed)
    with open(root / "annotation.csv") as f:
        for row in csv.DictReader(f):
            t = int(rng.integers(*steps))
            np.save(root / "amp" / f"{row['label']}.npy",
                    rng.random((t, channels), dtype=np.float32))
    return {"path.data_x": str(root / "amp"),
            "path.data_y": str(root / "annotation.csv"),
            "data.environment": ["classroom", "meeting_room",
                                 "empty_room"],
            "data.wifi_band": ["2.4", "5"], "data.length": 300}


def config_file(path, overrides):
    """The dotted overrides as a nested JSON config file at ``path``."""
    tree = {}
    for key, value in overrides.items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    path.write_text(json.dumps(tree))
    return str(path)


def skip_step_compile(monkeypatch):
    """JAX's fit compiles its training step ahead of the first epoch; at
    nn.epoch 0 no step runs, so its lazily compiled fallback is taken."""
    import multi_modal_csi_tpu.train.loop as jax_loop

    def refuse(*args, **kwargs):
        raise RuntimeError("no ahead-of-time compile at 0 epochs")

    monkeypatch.setattr(jax_loop, "aot_train_step", refuse)


def jax_logits(jmodel, variables, x):
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    return np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        v, x))


def port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def windows(key, n=3, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (n,) + NARROW[key], dtype=np.float32)


def test_reference_pt_loads_in_both_packages(tmp_path):
    """The repair of the port's loader: a reference file with the wrapper,
    stacked prefixes and the entries that carry no weight."""
    model = port_model("DETR", 3)
    state = {}
    for name, value in model.state_dict().items():
        state[f"module._orig_mod.{name}"] = value
        if name.endswith("running_var"):
            state["module._orig_mod." + name.replace(
                "running_var", "num_batches_tracked")] = torch.tensor(7)
    state["_orig_mod.encoder.layer_embedding_gaussian.var_position"] = (
        torch.arange(30.0)[:, None])
    state["decoder.norm.weight"] = state["decoder.norm.bias"] = torch.ones(64)
    path = str(tmp_path / "reference.pt")
    torch.save({"model_state_dict": state, "epoch": 3}, path)

    x = windows("DETR")
    fresh = port_model("DETR", 4)
    got = port_logits(checkpoint.restore_scenario(fresh, path, "full",
                                                  "DETR"), x)
    jmodel, like = jax_tree("DETR", port_model("DETR", 4))
    params, stats = jax_ckpt.restore_scenario(
        like["params"], like["batch_stats"], path, "full", model_key="DETR")
    want = jax_logits(jmodel, {"params": params, "batch_stats": stats}, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, port_logits(model, x))
    # the runner takes it as its pretrained_path
    cfg = Config().override(dict(OVERRIDES, model="DETR", **{
        "nn.epoch": 0, "pretrained_path": path}))
    res = runner.run_csi_model(cfg, set_data(NARROW["DETR"]), device="cpu")
    assert 0.0 <= res["accuracy"]["avg"] <= 100.0


@pytest.mark.parametrize("key", ["DETR", "THAT_ENCODER"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_port_component_file_restores_in_jax(tmp_path, key, scenario):
    saved, live = port_model(key, 5), port_model(key, 6)
    path = checkpoint.component_path(str(tmp_path), ["classroom", "lab"],
                                     key)
    assert path == str(tmp_path / "model_0" / f"PT_classroom_lab_{key}.pt")
    checkpoint.save_components(path, saved.state_dict())
    _, like = jax_tree(key, live)
    params, stats = jax_ckpt.restore_scenario(
        like["params"], like["batch_stats"], path, scenario, model_key=key)
    got = state_dict_from_jax(key, {"params": params, "batch_stats": stats},
                              num_decoder_layers=2)
    keep = checkpoint.SCENARIOS[scenario]
    for name, value in live.state_dict().items():
        src = saved if keep is None or name.split(".")[0] in keep else live
        np.testing.assert_array_equal(got[name].numpy(),
                                      src.state_dict()[name].numpy(), name)
    # and the port's own restore agrees
    mine = checkpoint.restore_scenario(port_model(key, 6), path, scenario,
                                       key).state_dict()
    for name, value in got.items():
        assert torch.equal(mine[name], value), name


def test_jax_msgpack_restores_in_port(tmp_path):
    """A JAX component file, also under a .pt name, and a bf16 one."""
    jmodel, variables = jax_tree("DETR", port_model("DETR", 7))
    path = str(tmp_path / "PT_DETR.msgpack")
    jax_ckpt.save_components(path, variables["params"],
                             variables["batch_stats"])
    x = windows("DETR")
    want = jax_logits(jmodel, variables, x)
    for name in ("PT_DETR.msgpack", "PT_DETR.pt"):
        if name != "PT_DETR.msgpack":
            (tmp_path / name).write_bytes((tmp_path / "PT_DETR.msgpack")
                                          .read_bytes())
        model = checkpoint.restore_scenario(
            port_model("DETR", 8), str(tmp_path / name), "full", "DETR")
        np.testing.assert_allclose(port_logits(model, x), want, rtol=1e-6,
                                   atol=1e-6)
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  variables["params"])
    jax_ckpt.save_components(str(tmp_path / "bf16.msgpack"), bf16,
                             variables["batch_stats"])
    state = checkpoint.load_components(str(tmp_path / "bf16.msgpack"),
                                       port_model("DETR", 8), "DETR")
    want_sd = state_dict_from_jax("DETR", {
        "params": jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), bf16),
        "batch_stats": variables["batch_stats"]}, num_decoder_layers=2)
    for name, value in want_sd.items():
        assert torch.equal(state[name], value), name
    with pytest.raises(ValueError, match="neither a torch checkpoint"):
        (tmp_path / "junk.pt").write_bytes(b"\x01\x02junk")
        checkpoint.load_components(str(tmp_path / "junk.pt"),
                                   port_model("DETR", 8), "DETR")


def _grads(like, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), like)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_transfer_optimizer_matches_jax(scenario):
    model = port_model("DETR", 9)
    _, variables = jax_tree("DETR", model)
    params = variables["params"]
    grads = _grads(params, 10)
    lr = 1e-3
    tx = jax_transfer_optimizer(params, lr, scenario)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = state_dict_from_jax("DETR", {
        "params": jax.tree_util.tree_map(lambda p, u: np.asarray(p + u),
                                         params, updates),
        "batch_stats": variables["batch_stats"]}, num_decoder_layers=2)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = transfer_optimizer(model, lr, scenario)
    port_grads = state_dict_from_jax(
        "DETR", {"params": grads, "batch_stats": variables["batch_stats"]},
        num_decoder_layers=2)
    for name, p in model.named_parameters():
        p.grad = port_grads[name].clone()
    opt.step()
    frozen = scenario == "feature_encoder"
    for name, p in model.named_parameters():
        if frozen and name.startswith("feature_extractor."):
            assert torch.equal(p, before[name]) and not p.requires_grad
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-7, err_msg=name)
    groups = [g["lr"] for g in opt.param_groups]
    assert groups == {"full": [lr], "feature_extractor": [lr * 0.01, lr],
                      "feature_encoder": [lr * 0.1, lr]}[scenario]


def test_frozen_feature_extractor_keeps_updating_statistics(no_jax_dropout):
    """Under feature_encoder a training step leaves the feature extractor's
    parameters as they were and updates its BatchNorm statistics as JAX's
    training forward does."""
    model = no_dropout(port_model("DETR", 11))
    jmodel, variables = jax_tree("DETR", model)
    x = windows("DETR", n=4, seed=12)
    y = set_data(NARROW["DETR"], n_tr=4, n_te=1)[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = transfer_optimizer(model, 1e-3, "feature_encoder")
    loss_fn = runner.CSI_MODELS["DETR"].make_loss(Config(), 10)
    model.train()
    loss = loss_fn(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    opt.step()
    _, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))(
        jax.tree_util.tree_map(jnp.asarray, variables), x)
    want = state_dict_from_jax("DETR", {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              mutated["batch_stats"])},
        num_decoder_layers=2)
    after = model.state_dict()
    moved = 0
    for name, value in after.items():
        if not name.startswith("feature_extractor."):
            continue
        if "running_" in name:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            moved += not torch.equal(value, before[name])
        else:
            assert torch.equal(value, before[name]), name
    assert moved == 8           # 4 dilated blocks' mean and var
    assert not torch.equal(after["encoder.layer_embedding_norm.weight"],
                           before["encoder.layer_embedding_norm.weight"])


def test_video_warm_start_and_save(tmp_path):
    """path.save_model: a missing file means fresh weights, which the run
    saves there; a run of 0 epochs warm-starts from the file and saves its
    weights back bit for bit; a run that trains saves weights that load
    strictly; a component file is also a pretrained_path."""
    from multi_modal_csi_tpu_torch.runners.video import build_video_model
    rng = np.random.default_rng(14)
    x = rng.standard_normal((6, 4, 32, 32, 3), dtype=np.float32)
    y = (rng.random((6, 6)) < 0.5).astype(np.float32)
    data = (x[:4], x[4:], y[:4], y[4:])
    path = str(tmp_path / "models" / "mvit.pt")
    cfg = Config().override({"model": "MViT-v2", "repeat": 1, "nn.epoch": 0,
                             "nn.batch_size": 2, "path.save_model": path})
    fresh = build_video_model("MViT-v2", 6, (4, 32, 32), seed=39)
    run_video_model(cfg, data, device="cpu")
    saved = torch.load(path, weights_only=True)
    assert all(torch.equal(saved[k], v)
               for k, v in fresh.state_dict().items())

    warm = perturbed(fresh, 15).state_dict()
    checkpoint.save_components(path, warm)
    run_video_model(cfg, data, device="cpu")
    saved = torch.load(path, weights_only=True)
    assert set(saved) == set(warm)
    assert all(torch.equal(saved[k], warm[k]) for k in warm)

    other = str(tmp_path / "other.pt")
    run_video_model(cfg.override({"path.save_model": other,
                                  "pretrained_path": path}), data,
                    device="cpu")
    saved = torch.load(other, weights_only=True)
    assert all(torch.equal(saved[k], warm[k]) for k in warm)

    run_video_model(cfg.override({"nn.epoch": 1}), data, device="cpu")
    build_video_model("MViT-v2", 6, (4, 32, 32)).load_state_dict(
        torch.load(path, weights_only=True), strict=True)
