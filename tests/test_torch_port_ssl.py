"""The port's SSL (models/csi/ssl.py, runners/ssl.py, cli/ssl_inference.py)
against the JAX package's, on the CPU, at (393, 30) windows (the fewest
steps CNN-1D's three strided stages take), with the
port's weights carried across by core/torch_import.py's SSL map.

- The forward in inference (the online head on the eval-mode backbone,
  whatever the model's mode), f32 within 1e-5, and in training
  composition at batch 8 (z1, z2 and the logits within 1e-5 of each
  one's largest magnitude, since the projector's BatchNorms normalise by
  8 samples' statistics; the BatchNorm statistics, which update once per
  view, within 1e-5), and bf16 inference within 2e-2 of the largest
  logit; dropout off on both sides.
- ``info_nce`` and ``ssl_loss`` within 1e-6 relative.
- One training step from fixed views at batch 8: the loss within 1e-5
  relative and each gradient within 1e-4 of its tensor's scale.
- ``run_ssl`` over 2 epochs with a deterministic ``view_fn`` (10 windows
  at batch 4, so the partial final batch of 2 trains), from JAX's initial
  weights of repeat 0: each epoch's mean loss within 1e-4 relative, the
  one-batch accuracy equal, and the final report equal.
- ``two_views``: each gate's share over 2000 seeded windows within 5
  binomial standard deviations of its probability, per view; the jitter's
  spread, the scale's range and the mask's 10 steps.
- ``cli/ssl_inference.py`` on the file ``run_ssl`` saved gives
  ``run_ssl``'s own test report, and JAX's ``ssl_inference`` on the same
  ``.pt`` gives the same report.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.cli import ssl_inference as jax_ssl_inference
from multi_modal_csi_tpu.core.config import Config as JaxConfig
from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.models.csi import ssl as J
from multi_modal_csi_tpu.runners import ssl as jax_ssl_runner
from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu_torch.cli import ssl_inference
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.models.csi import ssl as S
from multi_modal_csi_tpu_torch.runners import ssl as ssl_runner
from multi_modal_csi_tpu_torch.train.loop import cast_for_serving
from test_torch_port_checkpoint import config_file, write_narrow_dataset
from test_torch_port_layers import gen
from test_torch_port_runner import perturbed
from test_torch_port_train_step import no_dropout, no_jax_dropout  # noqa: F401

torch.set_num_threads(1)

SHAPE, OUT = (393, 30), 54     # CNN-1D's stages need 393 steps


def windows(n=4, seed=2, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal((n,) + shape,
                                                       dtype=np.float32)


def labels(n, seed=3):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, 6, 9), np.float32)
    for i in range(n):
        users = int(rng.integers(1, 4))
        y[i, np.arange(users), rng.integers(0, 9, users)] = 1.0
    return y


def pair(seed=1):
    """The port's SSL model (perturbed) and its weights in JAX's tree."""
    port = perturbed(S.SSLModel(OUT, channels=SHAPE[1], generator=gen(seed)),
                     seed)
    x = np.zeros((2,) + SHAPE, np.float32)
    shapes = jax.eval_shape(lambda: J.SSLModel(OUT).init(
        {"params": jax.random.PRNGKey(0)}, x, x, train=False))
    state = {k: v.clone() for k, v in port.state_dict().items()}
    return port, import_state_dict("SSL", state, shapes)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_forward_matches_jax(no_jax_dropout):
    port, variables = pair()
    no_dropout(port)
    x1, x2 = windows(n=8, seed=4), windows(n=8, seed=5)
    jmodel = J.SSLModel(OUT)
    want = np.asarray(jmodel.apply(jnp_tree(variables), x1, inference=True))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    (z1, z2, logits), mutated = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=True, mutable=["batch_stats"]))(
        jnp_tree(variables), x1, x2)
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(x1), torch.from_numpy(x2))
    for mine, theirs in zip(got, (z1, z2, logits)):
        theirs = np.asarray(theirs)
        assert np.abs(mine.numpy() - theirs).max() <= (
            1e-5 * np.abs(theirs).max())
    stats = state_dict_from_jax("SSL", {
        "params": variables["params"],
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              mutated["batch_stats"])})
    for name, value in port.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), stats[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    # the inference path runs the backbone in eval mode whatever the mode
    with torch.no_grad():
        again = port(torch.from_numpy(x1), inference=True).numpy()
    assert port.training and port.backbone.training
    want = np.asarray(jmodel.apply(
        {"params": jnp_tree(variables["params"]),
         "batch_stats": mutated["batch_stats"]}, x1, inference=True))
    np.testing.assert_allclose(again, want, rtol=1e-5, atol=1e-5)


def test_bf16_inference_matches_jax():
    port, variables = pair(seed=6)
    x = windows(seed=7)
    jv = jax_cast(jnp_tree(variables), jnp.bfloat16)
    want = np.asarray(J.SSLModel(OUT).apply(
        jv, jnp.asarray(x, jnp.bfloat16), inference=True).astype(jnp.float32))
    cast_for_serving(port.eval(), torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_info_nce_and_ssl_loss_match_jax():
    rng = np.random.default_rng(8)
    z1, z2 = (rng.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2))
    z1[0] = 0.0                      # the clipped norm
    logits = rng.standard_normal((6, OUT)).astype(np.float32)
    y = labels(6).reshape(6, -1)
    t = [torch.from_numpy(a) for a in (z1, z2, logits, y)]
    assert float(S.info_nce(t[0], t[1])) == pytest.approx(
        float(J.info_nce(z1, z2)), rel=1e-6)
    got = S.ssl_loss(*t)
    want = J.ssl_loss(z1, z2, logits, y)
    for mine, theirs in zip(got, want):
        assert float(mine) == pytest.approx(float(theirs), rel=1e-6)


def test_one_step_from_fixed_views(no_jax_dropout):
    port, variables = pair(seed=9)
    no_dropout(port)
    x1, x2, y = windows(n=8, seed=10), windows(n=8, seed=11), labels(8)
    y = y.reshape(8, -1)
    jmodel = J.SSLModel(OUT)

    def loss_fn(params):
        (z1, z2, lg), mut = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x1, x2, train=True, mutable=["batch_stats"])
        return J.ssl_loss(z1, z2, lg, y)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jnp_tree(variables["params"]))
    want = state_dict_from_jax("SSL", {
        "params": jax.tree_util.tree_map(np.asarray, jgrads),
        "batch_stats": variables["batch_stats"]})
    port.train()
    loss, _ = S.ssl_loss(*port(torch.from_numpy(x1), torch.from_numpy(x2)),
                         torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    params = dict(port.named_parameters())
    floor = 1e-2 * max(np.abs(want[n].numpy()).max() for n in params)
    for name, p in params.items():
        scale = max(np.abs(want[name].numpy()).max(), floor)
        assert np.abs(p.grad.numpy() - want[name].numpy()).max() <= (
            1e-4 * scale), name
    # the online head's input is detached: no gradient reaches the
    # backbone from the BCE
    assert port.online_head.weight.grad.abs().sum() > 0


def jax_initial_port(out, seed, x):
    """The port model on JAX run_ssl's initial weights of seed ``seed``."""
    rng = jax.random.PRNGKey(seed)
    init_rng, _ = jax.random.split(rng)
    variables = jax.jit(lambda r, a: J.SSLModel(out).init(
        {"params": r}, a, a, train=False))(init_rng, jnp.asarray(x[:2]))
    model = S.SSLModel(out, channels=x.shape[-1], generator=gen())
    model.load_state_dict(state_dict_from_jax(
        "SSL", jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return no_dropout(model)


def test_run_ssl_matches_jax(monkeypatch, no_jax_dropout):
    x = windows(n=16, seed=12)
    y = labels(16, seed=13)
    data = (x[:10], x[10:], y[:10], y[10:])
    overrides = {"repeat": 1, "nn.epoch": 2, "nn.batch_size": 4,
                 "nn.lr": 5e-5}
    want_history, got_history = [], []
    want = jax_ssl_runner.run_ssl(
        JaxConfig().override(overrides), data, history=want_history,
        view_fn=lambda rng, bx: (bx, bx * 0.8 + 0.1))
    monkeypatch.setattr(ssl_runner, "build_ssl",
                        lambda out, seed, ch: jax_initial_port(out, seed,
                                                               x[:10]))
    got = ssl_runner.run_ssl(
        Config().override(overrides), data, history=got_history,
        view_fn=lambda g, bx: (bx, bx * 0.8 + 0.1), device="cpu")
    assert len(got_history) == len(want_history) == 2
    for mine, theirs in zip(got_history, want_history):
        assert mine["train_loss"] == pytest.approx(theirs["train_loss"],
                                                   rel=1e-4)
        assert mine["accuracy_batch"] == theirs["accuracy_batch"]
    assert got["accuracy"]["avg"] == want["accuracy"]["avg"]
    assert list(got["repeat_0"]) == list(want["repeat_0"])
    for key, row in want["repeat_0"].items():
        for metric, value in row.items():
            assert got["repeat_0"][key][metric] == pytest.approx(
                value, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("view", [0, 1])
def test_two_views_gates(view):
    n, t, c = 2000, 30, 3
    gen_ = torch.Generator().manual_seed(14)
    probs = S.VIEW_PROBS[view]
    sigma = 5 * np.sqrt(0.25 / n)
    # on zeros only the jitter shows
    v = S.two_views(gen_, torch.zeros(n, t, c))[view]
    jittered = (v != 0).flatten(1).any(1).float().mean().item()
    assert abs(jittered - probs[0]) <= sigma
    assert v[v != 0].std().item() == pytest.approx(S.NOISE_LEVEL, rel=0.05)
    # on 1e6 the jitter is below float resolution, the scale is not, and
    # only the mask makes zeros
    big = torch.full((n, t, c), 1e6)
    v = S.two_views(gen_, big)[view]
    ratio = (v / big)
    kept = ratio != 0
    scaled = ((ratio - 1).abs() * kept > 1e-3).flatten(1).any(1)
    assert abs(scaled.float().mean().item() - probs[1]) <= sigma
    assert ratio[kept].min() >= 0.9 - 1e-6 and ratio[kept].max() <= 1.1
    masked = ~kept.all(2)                       # (n, t) masked steps
    rows = masked.any(1)
    assert abs(rows.float().mean().item() - probs[2]) <= sigma
    assert (masked[rows].sum(1) == S.MASK_LEN).all()
    first = masked[rows].float().argmax(1)
    assert (first < t - S.MASK_LEN).all()
    assert (~kept).any(2).equal(~kept.all(2))   # whole steps


def test_ssl_inference_on_a_saved_file(tmp_path, monkeypatch, capsys):
    overrides = dict(write_narrow_dataset(tmp_path, n=40, seed=15,
                                          steps=(380, 420)),
                     **{"data.length": SHAPE[0]})
    cfg_path = config_file(tmp_path / "cfg.json", overrides)
    cfg = Config().override(dict(overrides, **{
        "model": "SSL", "repeat": 1, "nn.epoch": 1, "nn.batch_size": 8}))
    saved = str(tmp_path / "ssl.pt")
    result = ssl_runner.run_ssl(cfg, save_path=saved, device="cpu")
    got = ssl_inference.main(["--checkpoint", saved, "--config", cfg_path,
                              "--device", "cpu"])
    assert got["accuracy"] == result["accuracy"]["avg"]
    assert got["report"] == result["repeat_0"]
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["ssl_inference", "--checkpoint",
                                      saved, "--config", cfg_path])
    jax_ssl_inference.main()
    want = json.loads(capsys.readouterr().out)
    assert want["accuracy"] == got["accuracy"]
    assert list(want["report"]) == list(got["report"])
    for key, row in want["report"].items():
        for metric, value in row.items():
            assert got["report"][key][metric] == pytest.approx(
                value, rel=1e-12, abs=1e-15)
