"""The WiMANS baselines of the port (MLP, CNN-1D, CNN-2D, LSTM, CLSTM,
ABLSTM: models/csi/, nn/layers.py's Conv2d and LSTM) against the JAX
package's, on the CPU, on the same weights: the port model's state dict
goes into the JAX tree with one ``import_state_dict`` call, is perturbed,
and comes back through ``core/weights.py::state_dict_from_jax``.

Sizes are those of the JAX package's tests/test_csi_models.py: 60 x 20
windows for MLP (flat), LSTM (hidden 32) and ABLSTM (hidden 16); 393 x 20
for CNN-1D (its three strides leave one step); 1800 x 6 for CLSTM (three
steps of LSTM 512); 251 x 251 for CNN-2D (a 1 x 1 map after stage 2).

- The f32 eval forward within 1e-5 (rtol and atol); the LSTM families
  within 2e-5: the steps' f32 roundings differ (torch.lstm on the CPU
  against JAX's scan).
- The LSTM layer's two paths in f32, ``torch.lstm`` (which f32 takes, cuDNN
  on the card) and the step loop ``lstm_steps`` (which bf16 takes), each
  within 1e-5 of JAX's LSTM, both directions.
- JAX's mixed precision in bf16: the LSTM layer over 300 and 375 steps in
  bf16 within one bf16 step of JAX's and a mean distance under 1e-5
  (torch.lstm run in bf16, c in bf16 and the gates rounded, is 1.5e-4
  off on average); bf16 serving of LSTM and ABLSTM (parameters and
  input cast, f32 logits) against JAX's bf16 forward within 2e-2 of the
  largest f32 logit.
- ``state_dict_from_jax`` loads with strict=True and round-trips through
  JAX's ``import_state_dict`` bit for bit, for all six keys.
- The runner's table, ``build_model``, and ``CSIServer`` feeding MLP
  (n, T, C) requests, which the model flattens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.core.torch_import import import_state_dict
from multi_modal_csi_tpu.models import csi as JM
from multi_modal_csi_tpu.nn import layers as J
from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu_torch.core import weights as W
from multi_modal_csi_tpu_torch.core.config import Config
from multi_modal_csi_tpu_torch.core.serving import CSIServer
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.runners import csi as runner
from test_torch_port_layers import gen, perturb, run, to_torch

torch.set_num_threads(1)

OUT = 54
# key: (JAX model, port model built from a generator, window (T, F))
CASES = {
    "MLP": (lambda: JM.MLP(out_features=OUT),
            lambda g: runner.csi_models.MLP(OUT, in_features=60 * 20,
                                            generator=g), (60, 20)),
    "CNN-1D": (lambda: JM.CNN1D(out_features=OUT),
               lambda g: runner.csi_models.CNN1D(OUT, channels=20,
                                                 generator=g), (393, 20)),
    "CNN-2D": (lambda: JM.CNN2D(out_features=OUT),
               lambda g: runner.csi_models.CNN2D(OUT, generator=g),
               (251, 251)),
    "LSTM": (lambda: JM.LSTMModel(out_features=OUT, hidden=32),
             lambda g: runner.csi_models.LSTMModel(OUT, channels=20,
                                                   hidden=32, generator=g),
             (60, 20)),
    "CLSTM": (lambda: JM.CLSTM(out_features=OUT),
              lambda g: runner.csi_models.CLSTM(OUT, channels=6,
                                                generator=g), (1800, 6)),
    "ABLSTM": (lambda: JM.ABLSTM(out_features=OUT, hidden=16),
               lambda g: runner.csi_models.ABLSTM(OUT, channels=20,
                                                  hidden=16, generator=g),
               (60, 20)),
}
KEYS = sorted(CASES)
F32_TOL = {"LSTM": 2e-5, "CLSTM": 2e-5, "ABLSTM": 2e-5}   # else 1e-5
BF16_SHARE = 2e-2          # bf16 serving vs JAX bf16, of the largest logit


def windows(key, n=3, seed=2):
    """(n, T, F) standard normals; MLP's flattened to (n, T F)."""
    t, f = CASES[key][2]
    x = np.random.default_rng(seed).standard_normal((n, t, f),
                                                    dtype=np.float32)
    return x.reshape(n, -1) if key == "MLP" else x


def jax_variables(key, jmodel, port, seed=1):
    """The port model's weights in JAX's tree (one import_state_dict
    call), perturbed."""
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False),
        windows(key, 1))
    return perturb(import_state_dict(key, port.state_dict(), shapes), seed)


def pair(key, seed=1):
    """JAX model, perturbed numpy variables and the port model on them
    (eval mode)."""
    make_jax, make_port, _ = CASES[key]
    jmodel, port = make_jax(), make_port(gen())
    variables = jax_variables(key, jmodel, port, seed)
    port.load_state_dict(W.state_dict_from_jax(key, variables), strict=True)
    return jmodel, variables, port.eval()


def jax_forward(jmodel, variables, x, dtype=jnp.float32):
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    if dtype != jnp.float32:
        v = jax_cast(v, dtype)
    return np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x.astype(dtype), train=False).astype(jnp.float32))(v, x))


def lstm_pair(steps, hidden, bidirectional, seed=4):
    """JAX's LSTM layer with perturbed variables, the port's on them, and
    (4, steps, 20) inputs."""
    x = np.random.default_rng(seed).standard_normal((4, steps, 20),
                                                    dtype=np.float32)
    jlayer = J.LSTM(hidden, bidirectional=bidirectional)
    variables = perturb(jax.tree_util.tree_map(
        np.asarray, jlayer.init(jax.random.PRNGKey(0), x)))
    sd = {}
    W._lstm(sd, variables["params"], "m")
    if bidirectional:
        W._lstm(sd, variables["params"], "m", "bwd", "l0_reverse")
    layer = P.LSTM(20, hidden, bidirectional=bidirectional, generator=gen())
    torch.nn.ModuleDict({"m": layer}).load_state_dict(sd, strict=True)
    return jlayer, variables, layer, x


@pytest.mark.parametrize("key", KEYS)
def test_f32_forward_matches_jax(key):
    jmodel, variables, port = pair(key)
    x = windows(key)
    want = jax_forward(jmodel, variables, x)
    got = run(port, to_torch(x)).numpy()
    assert got.shape == want.shape == (3, OUT)
    tol = F32_TOL.get(key, 1e-5)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_layer_paths_match_jax(bidirectional):
    """Both paths of the port's LSTM in f32 against JAX's scan: 37 steps
    of (4, 37, 20) inputs, hidden 24."""
    jlayer, variables, layer, x = lstm_pair(37, 24, bidirectional)
    want = np.asarray(jlayer.apply(variables, x))
    got = run(layer, to_torch(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    loop = run(P.lstm_steps, to_torch(x), *layer._params("l0")).numpy()
    np.testing.assert_allclose(loop, want[..., :24], rtol=1e-5, atol=1e-5)
    if bidirectional:
        back = run(P.lstm_steps, to_torch(x).flip(1),
                   *layer._params("l0_reverse")).flip(1).numpy()
        np.testing.assert_allclose(back, want[..., 24:], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("steps,hidden,bidirectional",
                         [(300, 32, False), (375, 16, True)],
                         ids=["lstm-300", "bilstm-375"])
def test_lstm_layer_bf16_keeps_jax_precision(steps, hidden, bidirectional):
    """The LSTM layer in bf16 (bf16 weights and input) over LSTM's 300
    and ABLSTM's 375 steps against JAX's in bf16: every h within one bf16
    step (2^-8) of JAX's and the mean distance under 1e-5 (measured: 0
    and 3e-8, a single flip). torch.lstm run in bf16, which keeps c in
    bf16 and rounds the gates, is printed beside it (measured: a mean of
    1.5e-4 and 1.6e-4, a bf16 step at most)."""
    jlayer, variables, layer, x = lstm_pair(steps, hidden, bidirectional)
    vb = jax_cast(jax.tree_util.tree_map(jnp.asarray, variables),
                  jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x: jlayer.apply(
        v, x.astype(jnp.bfloat16)).astype(jnp.float32))(vb, x))
    layer = layer.to(torch.bfloat16)
    xb = to_torch(x).to(torch.bfloat16)
    got = run(layer, xb).float().numpy()
    params = [p for s in layer._suffixes() for p in layer._params(s)]
    zeros = xb.new_zeros((len(layer._suffixes()), 4, hidden))
    naive = run(torch.lstm, xb, (zeros, zeros), params, True, 1, 0.0,
                False, bidirectional, True)[0].float().numpy()
    diff, naive_diff = np.abs(got - want), np.abs(naive - want)
    print(f"bf16 LSTM over {steps} steps: port max {diff.max():.3g} mean "
          f"{diff.mean():.3g}; torch.lstm in bf16 max {naive_diff.max():.3g}"
          f" mean {naive_diff.mean():.3g}")
    assert diff.max() <= 2.0 ** -8 and diff.mean() <= 1e-5


@pytest.mark.parametrize("key", ["LSTM", "ABLSTM"])
def test_bf16_serving_matches_jax_bf16(key):
    """bf16 serving (parameters and input cast, f32 logits) against JAX's
    bf16 forward within 2e-2 of the largest f32 logit. Both round the
    logits to bf16 and round the average pool at different places (JAX
    sums in bf16, then divides); measured 6.7e-3 (LSTM) and 6.3e-3
    (ABLSTM), while JAX's bf16 logits are 4.0e-3 from its f32 ones."""
    jmodel, variables, port = pair(key)
    x = windows(key, n=4, seed=5)
    f32 = jax_forward(jmodel, variables, x)
    want = jax_forward(jmodel, variables, x, jnp.bfloat16)
    got = CSIServer(key, port, dtype="bfloat16", device="cpu", batch=4)(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= BF16_SHARE * np.abs(f32).max()


@pytest.mark.parametrize("key", KEYS)
def test_state_dict_round_trips_through_jax(key):
    """state_dict_from_jax loads strictly, and JAX's import_state_dict
    takes it back bit for bit."""
    jmodel, variables, port = pair(key)
    sd = W.state_dict_from_jax(key, variables)
    assert set(sd) == set(port.state_dict())
    back = import_state_dict(key, sd, variables)
    flat = jax.tree_util.tree_leaves_with_path(variables)
    again = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(again)
    for path, leaf in flat:
        assert np.array_equal(np.asarray(again[path]), leaf), path


def test_runner_table_and_build_model():
    """The six keys in the model table with JAX's losses, layouts and
    weight decays; build_model at full width; only ST-RF, SSL and
    dual_band still raise."""
    assert runner.UNPORTED_MODELS == ("ST-RF", "SSL", "dual_band")
    for key in KEYS:
        spec = runner.CSI_MODELS[key]
        assert spec.mode == "baseline" and spec.target == "raw"
        assert spec.input_layout == ("flat" if key == "MLP" else "seq")
        assert spec.final_eval == ("count_round" if key == "CNN-1D"
                                   else "report")
        assert spec.weight_decay == {"MLP": 1e-3, "CNN-2D": 1e-4}.get(key,
                                                                      0.0)
    o = torch.tensor([[0.3, -1.2]])
    t = torch.tensor([[1.0, 0.0]])
    for key, pw in (("MLP", 4.0), ("LSTM", 6.0), ("CNN-2D", 6.0),
                    ("CLSTM", 8.0), ("ABLSTM", 6.0)):
        loss = runner.CSI_MODELS[key].make_loss(Config(), OUT)(o, t)
        assert float(loss) == float(bce_with_logits(o, t, pw)), key
    assert float(runner.CSI_MODELS["CNN-1D"].make_loss(Config(), OUT)(
        o, t)) == pytest.approx((0.7 ** 2 + 1.2 ** 2) / 2, rel=1e-6)
    model = runner.build_model("LSTM", seed=0)
    assert not model.training
    assert model.layer_lstm.weight_ih_l0.shape == (2048, 270)
    assert runner.infer_out_dim("CNN-2D", "location") == 30
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        runner.build_model("SSL")


def test_mlp_server_flattens_windows():
    """CSIServer feeds MLP (n, T, C) windows, which the model flattens: 5
    windows at batch 2, the last batch zero-padded and cut."""
    _, _, port = pair("MLP")
    x = windows("MLP", n=5, seed=7)
    want = run(port, to_torch(x)).numpy()
    server = CSIServer("MLP", port, dtype="float32", device="cpu", batch=2)
    got = server(x.reshape(5, 60, 20)).numpy()
    assert got.shape == (5, OUT)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
