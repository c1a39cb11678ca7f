"""The port's S3D (models/video/s3d.py) against the JAX package's on the
CPU, with test_torch_port_video_backbones.py's helpers and tolerances: full
width on (2, 8, 96, 96, 3) clips; the eval forward, bf16 serving and
``load_video_pretrained`` with torchvision's 1x1x1 classifier conv.

Train mode is held stage by stage. S3D's BatchNorms (flax's momentum
0.999, eps 1e-3) take their statistics over few positions in its last
stages at any clip a CPU test can run, and the whole train-mode forward
is ill-conditioned there: against the port's own float64 forward, JAX's
f32 logits are 6.7e-4 of the largest logit away and the port's 3.3e-5
at these clips, and the gradients of a whole step differ from float64 by
2-50% of their scale in either package (measured at (8, 48..96, 48..96)
clips, batch 2 and 4). So each stage (the stem, conv2, conv3 and the
nine mixed blocks) is fed its input from the port's own train-mode
forward, in both packages, and held in train mode: its output within
1e-4 of its largest magnitude, its moved running statistics within 1e-5
(of each tensor's largest magnitude, at least 1), and its backward for a
seeded cotangent (``jax.vjp`` against autograd): each parameter's gradient
and the input's within 1e-4 of its largest magnitude (floored at 1e-2 of
the stage's largest). Each tolerance also admits twice JAX's own
resolution at that input: how far JAX's result moves when each element
of the stage's input moves by an ulp (``one_ulp``), which no change of
the port can widen. It is below 3e-5 of the scale everywhere but at
mixed_4's branch1, whose gradients JAX moves by 6.6e-2 of their scale:
one channel's value that JAX puts on its ReLU's kink (a bias gradient
of 1 of 256 channels and 0.4% of the spatial conv's weights differ; the
port's gradients there are within 3e-6 of its float64 run). The head
(the clipped sliding average pool, ``classifier`` and ``task_head``) is
the last stage: fed the port's train-mode features ((2, 1, 3, 3, 1024)
at these clips, where the window clips to (1, 3, 3) and one position is
left) and a seeded (2, 3, 9, 9, 1024) input (a (2, 7, 7) window sliding
over 2 x 3 x 3 positions), and held under BCE against ``jax.vjp`` of the
same three steps built from the JAX package's ``Linear`` and flax's
``avg_pool``, as JAX's ``S3D.__call__`` runs them: the loss within 1e-4
relative, the head's gradients and its input's within 1e-4 as the
stages'. The max pools between the stages have no
parameters and run as in the eval forward.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.models.video import s3d as jax_s3d
from multi_modal_csi_tpu.nn.layers import Linear as JaxLinear
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.core.weights import (S3D_MIXED_FEATURES,
                                                    state_dict_from_jax)
from test_torch_port_video_backbones import (CLIPS, OUT, Pair, check_bf16,
                                             check_forward, check_pretrained)

torch.set_num_threads(1)

STAGE_TOL = 1e-4
STATS_TOL = 1e-5
# the head's inputs: the features of the forward, and a wider one
HEADS = {"head": None, "head_wide": (2, 3, 9, 9, 1024)}


def stages():
    """(JAX name, port feature index, JAX module) of each stage."""
    out = [("stem", 0, jax_s3d.SepConv(64, kernel=7, stride=2, padding=3)),
           ("conv2", 2, jax_s3d.ConvBN(64, (1, 1, 1))),
           ("conv3", 3, jax_s3d.SepConv(192))]
    cfgs = [c for c in jax_s3d.MIXED_CFG if not isinstance(c, str)]
    out += [(f"mixed_{i}", fi, jax_s3d.MixedBlock(*cfg))
            for i, (fi, cfg) in enumerate(zip(S3D_MIXED_FEATURES, cfgs))]
    return out


class JaxHead(fnn.Module):
    """JAX's S3D head (``S3D.__call__`` after the last mixed block, dropout
    off): the sliding average pool clipped to the features, the 400-way
    ``classifier`` over every position, the mean, the task ``head``."""

    @fnn.compact
    def __call__(self, x):
        window = tuple(min(k, s) for k, s in zip((2, 7, 7), x.shape[1:4]))
        x = fnn.avg_pool(x, window_shape=window, strides=(1, 1, 1),
                         padding="VALID")
        x = JaxLinear(400, xavier=False, name="classifier")(x)
        return JaxLinear(OUT, xavier=False, name="head")(
            jnp.mean(x, axis=(1, 2, 3)))


def port_head(port, features):
    """The port's head (``S3DBackbone.forward`` after its features, then
    ``task_head``) on ``features``: the model run with its features
    replaced by the identity."""
    real = port.backbone.features
    port.backbone.features = nn.Identity()
    try:
        return port(features)
    finally:
        port.backbone.features = real


def port_stages(pair):
    """Each stage's input in the port's train-mode forward, then, from
    the original weights and statistics, each stage run alone in train
    mode on that input: (inputs, cotangents, outputs, input gradients,
    parameter gradients and moved state by port name). The heads' inputs
    are the features' output and a seeded HEADS shape, their outputs the
    BCE loss, their parameter gradients summed."""
    port = pair.port
    features = port.backbone.features
    before = {k: v.clone() for k, v in port.state_dict().items()}
    inputs = {}

    def keep(name):
        def hook(module, args):
            inputs[name] = args[0].detach().clone()
        return hook

    hooks = [features[fi].register_forward_pre_hook(keep(name))
             for name, fi, _ in stages()]
    hooks.append(features.register_forward_hook(
        lambda module, args, out: inputs.__setitem__(
            "head", out.detach().clone())))
    port.train()
    try:
        with torch.no_grad():
            port(torch.from_numpy(pair.x))
        for h in hooks:
            h.remove()
        port.load_state_dict(before)
        rng = np.random.default_rng(7)
        cts, outs, xgrads = {}, {}, {}
        for name, fi, _ in stages():
            x = inputs[name].clone().requires_grad_(True)
            y = features[fi](x)
            cts[name] = torch.from_numpy(
                rng.standard_normal(tuple(y.shape)).astype(np.float32))
            (y * cts[name]).sum().backward()
            outs[name], xgrads[name] = y.detach().numpy(), x.grad.numpy()
        inputs["head_wide"] = torch.from_numpy(rng.standard_normal(
            HEADS["head_wide"]).astype(np.float32))
        for name in HEADS:
            x = inputs[name].clone().requires_grad_(True)
            loss = bce_with_logits(port_head(port, x),
                                   torch.from_numpy(pair.y))
            loss.backward()
            outs[name], xgrads[name] = loss.detach().numpy(), x.grad.numpy()
        grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()
                 if p.grad is not None}
        moved = {k: v.clone() for k, v in port.state_dict().items()}
    finally:
        port.zero_grad(set_to_none=True)
        port.load_state_dict(before)
        port.eval()
    return inputs, cts, outs, xgrads, grads, moved


def one_ulp(inputs, seed=0):
    """Each input element scaled by 1 +- 2^-23 (a seeded sign an element):
    moved by one or two f32 ulps, zeros kept."""
    rng = np.random.default_rng(seed)
    return {k: v * torch.from_numpy(
        1 + 2.0 ** -23 * rng.choice([-1.0, 1.0], tuple(v.shape))).float()
        for k, v in inputs.items()}


def jax_stages(pair, inputs, cts):
    """JAX's stages in train mode on the same inputs and cotangents, in one
    compiled program, and again on inputs one ulp away: for each, (outputs,
    input gradients, the parameter gradients and moved statistics as port
    state dicts)."""
    params, stats = pair.variables["params"], pair.variables["batch_stats"]
    labels = jnp.asarray(pair.y)
    mods = stages()

    def run(params, xs, cts):
        outs, xgrads, pgrads, moved = {}, {}, {}, {}
        for name, _, mod in mods:
            def f(p, x, mod=mod, name=name):
                y, m = mod.apply({"params": p, "batch_stats": stats[name]},
                                 x, train=True, mutable=["batch_stats"])
                return y, m["batch_stats"]
            y, vjp, moved[name] = jax.vjp(f, params[name], xs[name],
                                          has_aux=True)
            pgrads[name], xgrads[name] = vjp(cts[name])
            outs[name] = y

        def head(p, x):
            return jax_bce(JaxHead().apply({"params": p}, x), labels)
        head_params = {k: params[k] for k in ("classifier", "head")}
        head_grads = []
        for name in HEADS:
            outs[name], vjp = jax.vjp(head, head_params, xs[name])
            g, xgrads[name] = vjp(jnp.ones_like(outs[name]))
            head_grads.append(g)
        pgrads.update(jax.tree_util.tree_map(jnp.add, *head_grads))
        return outs, xgrads, pgrads, moved

    as_j = lambda d: {k: jnp.asarray(v.numpy()) for k, v in d.items()}  # noqa
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
    compiled = jax.jit(run)
    results = []
    for xs in (inputs, one_ulp(inputs)):
        outs, xgrads, pgrads, moved = compiled(params, as_j(xs), as_j(cts))
        full_grads = dict(jax.tree_util.tree_map(np.zeros_like, params))
        full_stats = dict(stats)
        full_grads.update(pgrads)
        full_stats.update(moved)
        grads = state_dict_from_jax("S3D", {
            "params": as_np(full_grads), "batch_stats": as_np(full_stats)})
        moved_sd = state_dict_from_jax("S3D", {
            "params": params, "batch_stats": as_np(full_stats)})
        results.append((as_np(outs), as_np(xgrads), grads, moved_sd))
    return results


@pytest.fixture(scope="module")
def pair():
    assert CLIPS["S3D"] == (8, 96, 96)
    return Pair("S3D")


@pytest.fixture(scope="module")
def staged(pair):
    inputs, cts, outs, xgrads, grads, moved = port_stages(pair)
    return (outs, xgrads, grads, moved), *jax_stages(pair, inputs, cts)


def within(got, want, moved, scale, tol, what):
    """``got`` within ``tol`` of ``scale`` of ``want``, plus twice JAX's
    move ``want`` - ``moved`` under the one-ulp input."""
    resolution = float(np.abs(want - moved).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * scale + 2 * resolution,
                               err_msg=what)


def test_forward_matches_jax(pair):
    check_forward(pair, "eval")


def test_train_stages_match_jax(staged):
    (outs, _, _, moved), (jouts, _, _, jmoved), (nouts, _, _, nmoved) = staged
    for name, fi, _ in stages():
        want = jouts[name]
        assert outs[name].shape == want.shape, name
        within(outs[name], want, nouts[name], np.abs(want).max(), STAGE_TOL,
               name)
        prefix = f"backbone.features.{fi}."
        stats = [k for k in moved if k.startswith(prefix)
                 and k.endswith(("running_mean", "running_var"))]
        assert stats, name
        for k in stats:
            w = jmoved[k].numpy()
            within(moved[k].numpy(), w, nmoved[k].numpy(),
                   max(1.0, np.abs(w).max()), STATS_TOL, k)


def test_train_step_matches_jax(staged):
    (_, xgrads, grads, _), (_, jxgrads, jgrads, _), (_, nx, ngrads, _) = (
        staged)
    for name, fi, _ in stages():
        prefix = f"backbone.features.{fi}."
        names = [n for n in grads if n.startswith(prefix)]
        assert names, name
        floor = 1e-2 * max(np.abs(jgrads[n].numpy()).max() for n in names)
        for n in names:
            w = jgrads[n].numpy()
            within(grads[n], w, ngrads[n].numpy(),
                   max(np.abs(w).max(), floor), STAGE_TOL, n)
        w = jxgrads[name]
        within(xgrads[name], w, nx[name], np.abs(w).max(), STAGE_TOL,
               f"{name} input")


def test_train_head_matches_jax(staged):
    (outs, xgrads, grads, _), (jouts, jxgrads, jgrads, _), (
        nouts, nx, ngrads, _) = staged
    for name in HEADS:
        loss, want = float(outs[name]), float(jouts[name])
        assert abs(loss - want) <= STAGE_TOL * abs(want) + 2 * abs(
            want - float(nouts[name])), name
        w = jxgrads[name]
        within(xgrads[name], w, nx[name], np.abs(w).max(), STAGE_TOL,
               f"{name} input")
    names = [n for n in grads
             if n.startswith(("backbone.classifier.", "task_head."))]
    assert len(names) == 4, names
    floor = 1e-2 * max(np.abs(jgrads[n].numpy()).max() for n in names)
    for n in names:
        w = jgrads[n].numpy()
        within(grads[n], w, ngrads[n].numpy(), max(np.abs(w).max(), floor),
               STAGE_TOL, n)


def test_bf16_serving_matches_jax(pair):
    check_bf16(pair)


def test_load_video_pretrained_matches_jax(tmp_path):
    check_pretrained("S3D", tmp_path)
