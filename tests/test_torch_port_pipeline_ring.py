"""The port's GPipe (parallel/pipeline.py), ring attention
(kernels/ring_attention.py) and entry points (entry.py) on the CPU, against
the JAX package.

One group of 4 gloo ranks, started once for the module, runs:

- ``pipeline_apply`` over a "pipe" axis of 4 on JAX's toy stage
  (``x + tanh(x @ w + b)``) at 1, 2 and 9 microbatches: the outputs on
  every rank against JAX's ``pipeline_apply`` (within 1e-6), and the
  gradients of sum(out^2) with respect to the stacked parameters, every
  rank calling ``backward`` on the same loss (each rank holds its stage's
  part), against ``jax.grad`` of JAX's pipeline (within 1e-5: the last
  stage takes the gradient once, not once per rank); DP x PP on a
  ("pipe", "data") = (2, 2) mesh (each data rank's rows) against JAX's on
  the same mesh; 4 of THAT's EncoderBlocks as the stages (JAX's weights,
  eval mode) within 1e-5;
- ``ring_attention`` over a "data" axis of 4 at 64, 128 and 512 tokens
  against JAX's ``ring_attention`` on 4 devices and
  ``full_attention_reference`` (rtol 2e-4, atol 2e-5), and its q, k and v
  gradients of sum(out * w) against ``jax.grad`` of JAX's ring;
- ``dryrun_multichip(4, device="cpu")`` in that group: it completes
  (JAX's asserts) and rank 0 prints its line.

In the pytest process: ``entry(device="cpu")`` against JAX's entry model
(``__graft_entry__.py::entry``'s DETR and its constructor arguments)
holding the port entry's weights (carried by JAX's own importer,
``core/torch_import.py``), on the example input and on a random batch
(within 1e-4 of the largest logit).

The ranks import this module (no JAX in them); the JAX side runs in the
pytest process while they run.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from test_torch_port_parallel import (join_ranks, rank_main,  # noqa: F401
                                      start_ranks)

torch.set_num_threads(1)

MODULE = "test_torch_port_pipeline_ring"
RANKS = 4
MICRO = (1, 2, 9)            # microbatch counts
RING_N = (64, 128, 512)
ENC_D, ENC_TOKENS = 30, 24


def toy_params(n_stages=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
             "b": rng.normal(size=(d,)).astype(np.float32)}
            for _ in range(n_stages)]


def micro(n_micro, mb=2, d=16):
    return np.random.default_rng(n_micro).normal(
        size=(n_micro, mb, d)).astype(np.float32)


def ring_inputs(n):
    rng = np.random.default_rng(n)
    return [rng.normal(size=(2, 4, n, 16)).astype(np.float32)
            for _ in range(4)]                     # q, k, v, cotangent


def encoder_inputs():
    rng = np.random.default_rng(7)
    return rng.normal(size=(3, 2, ENC_TOKENS, ENC_D)).astype(np.float32)


# ---------------------------------------------------------------------- #
# the ranks
# ---------------------------------------------------------------------- #

def toy_stage(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


def stacked_torch(params, grad=False):
    from multi_modal_csi_tpu_torch.parallel.pipeline import (
        stack_stage_params)
    stacked = stack_stage_params([{k: torch.from_numpy(v)
                                   for k, v in p.items()} for p in params])
    return {k: v.requires_grad_(grad) for k, v in stacked.items()}


def pipeline_rank(mesh):
    from multi_modal_csi_tpu_torch.parallel.collectives import (axis_index,
                                                                axis_scope)
    from multi_modal_csi_tpu_torch.parallel.pipeline import pipeline_apply
    res = {"forward": {}, "grads": {}}
    with axis_scope(mesh["pipe4"]):
        res["stage"] = axis_index("pipe")
        for n in MICRO:
            stacked = stacked_torch(toy_params(), grad=True)
            out = pipeline_apply(toy_stage, stacked,
                                 torch.from_numpy(micro(n)))
            (out ** 2).sum().backward()
            res["forward"][n] = out.detach()
            res["grads"][n] = {k: v.grad for k, v in stacked.items()}
    with axis_scope(mesh["dp_pp"]):
        res["dp_pp"] = pipeline_apply(
            toy_stage, stacked_torch(toy_params(n_stages=2)),
            torch.from_numpy(micro(6, mb=4)), data_axis="data").detach()
    return res


def encoder_rank(mesh, states):
    from torch.func import functional_call
    from multi_modal_csi_tpu_torch.models.csi.that import EncoderBlock
    from multi_modal_csi_tpu_torch.parallel.collectives import axis_scope
    from multi_modal_csi_tpu_torch.parallel.pipeline import (
        pipeline_apply, stack_stage_params)
    block = EncoderBlock(ENC_D, 10, (1, 3, 5),
                         generator=torch.Generator().manual_seed(0)).eval()
    stacked = stack_stage_params(states)

    def stage(p, x):
        return functional_call(block, p, (x,))

    with axis_scope(mesh["pipe4"]), torch.no_grad():
        return pipeline_apply(stage, stacked,
                              torch.from_numpy(encoder_inputs()))


def ring_rank(mesh):
    from multi_modal_csi_tpu_torch.kernels.ring_attention import (
        ring_attention)
    from multi_modal_csi_tpu_torch.parallel.collectives import (axis_index,
                                                                axis_scope)
    res = {}
    with axis_scope(mesh["ring"]):
        i = axis_index("data")
        for n in RING_N:
            block = slice(i * n // RANKS, (i + 1) * n // RANKS)
            q, k, v, w = (torch.from_numpy(a[:, :, block]).requires_grad_()
                          for a in ring_inputs(n))
            out = ring_attention(q, k, v, "data")
            (out * w).sum().backward()
            res[n] = (out.detach(), q.grad, k.grad, v.grad)
    return res


def ranks_main(rank, world, states_path):
    from multi_modal_csi_tpu_torch.entry import dryrun_multichip
    from multi_modal_csi_tpu_torch.parallel.mesh import create_mesh
    mesh = {"pipe4": create_mesh({"pipe": RANKS}),
            "dp_pp": create_mesh({"pipe": 2, "data": 2}),
            "ring": create_mesh({"data": RANKS})}
    res = {"pipeline": pipeline_rank(mesh),
           "encoder": encoder_rank(mesh, torch.load(states_path)),
           "ring": ring_rank(mesh)}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(RANKS, device="cpu")
    res["dryrun"] = printed.getvalue()
    return res


# ---------------------------------------------------------------------- #
# the JAX side, in the pytest process
# ---------------------------------------------------------------------- #

def jax_pipeline():
    import jax
    import jax.numpy as jnp
    from multi_modal_csi_tpu.parallel.mesh import create_mesh
    from multi_modal_csi_tpu.parallel.pipeline import (pipeline_apply,
                                                       stack_stage_params)

    def stage(p, x):
        return x + jnp.tanh(x @ p["w"] + p["b"])

    def stacked(n_stages=4):
        return stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                   for p in toy_params(n_stages)])

    mesh = create_mesh({"pipe": RANKS}, devices=jax.devices()[:RANKS])

    def loss(p, x):
        y = pipeline_apply(stage, p, x, mesh)
        return jnp.sum(y ** 2), y

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    out = {"forward": {}, "grads": {}}
    for n in MICRO:
        (_, y), grads = value_and_grad(stacked(), micro(n))
        out["forward"][n] = np.asarray(y)
        out["grads"][n] = jax.tree_util.tree_map(np.asarray, grads)
    dp_mesh = create_mesh({"pipe": 2, "data": 2},
                          devices=jax.devices()[:RANKS])
    out["dp_pp"] = np.asarray(jax.jit(lambda p, x: pipeline_apply(
        stage, p, x, dp_mesh, data_axis="data"))(stacked(2), micro(6, mb=4)))
    return out


def jax_encoder():
    """JAX's 4 EncoderBlocks' variables (one init each), their port state
    dicts, and JAX's pipeline of them."""
    import jax
    import jax.numpy as jnp
    from multi_modal_csi_tpu.models.csi.that import EncoderBlock
    from multi_modal_csi_tpu.parallel.mesh import create_mesh
    from multi_modal_csi_tpu.parallel.pipeline import (pipeline_apply,
                                                       stack_stage_params)
    from multi_modal_csi_tpu_torch.core.weights import _encoder_block
    block = EncoderBlock(dim_feature=ENC_D, num_heads=10,
                         conv_sizes=(1, 3, 5))
    init = jax.jit(lambda k, x: block.init({"params": k}, x, False))
    x0 = jnp.zeros((2, ENC_TOKENS, ENC_D))
    variables = [init(k, x0) for k in jax.random.split(
        jax.random.PRNGKey(0), RANKS)]
    states = []
    for v in variables:
        sd = {}
        _encoder_block(sd, jax.tree_util.tree_map(np.asarray, v["params"]),
                       jax.tree_util.tree_map(np.asarray, v["batch_stats"]),
                       "block", 3)
        states.append({k[len("block."):]: t for k, t in sd.items()})
    mesh = create_mesh({"pipe": RANKS}, devices=jax.devices()[:RANKS])
    out = jax.jit(lambda v, x: pipeline_apply(
        lambda p, y: block.apply(p, y, False), v, x, mesh))(
            stack_stage_params(variables), encoder_inputs())
    return states, np.asarray(out)


def jax_ring():
    import jax
    import jax.numpy as jnp
    from multi_modal_csi_tpu.kernels.ring_attention import (
        full_attention_reference, ring_attention)
    from multi_modal_csi_tpu.parallel.mesh import create_mesh
    mesh = create_mesh({"data": RANKS, "model": 1},
                       devices=jax.devices()[:RANKS])
    def loss(q, k, v, w):
        y = ring_attention(q, k, v, mesh)
        return jnp.sum(y * w), y

    value_and_grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                has_aux=True))
    out = {}
    for n in RING_N:
        q, k, v, w = (jnp.asarray(a) for a in ring_inputs(n))
        (_, y), grads = value_and_grad(q, k, v, w)
        out[n] = (np.asarray(y),
                  np.asarray(full_attention_reference(q, k, v)),
                  [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_ring")
    states, encoder_out = jax_encoder()
    path = os.path.join(str(tmp), "states.pt")
    torch.save(states, path)
    procs = start_ranks(MODULE, f"{MODULE}:ranks_main", tmp, ranks=RANKS,
                        kwargs={"states_path": path})
    try:
        refs = {"pipeline": jax_pipeline(), "encoder": encoder_out,
                "ring": jax_ring()}
    finally:
        ranks = join_ranks(procs, tmp)
    return ranks, refs


def test_pipeline_forward_matches_jax(runs):
    ranks, refs = runs
    for res in ranks:
        for n in MICRO:
            np.testing.assert_allclose(res["pipeline"]["forward"][n].numpy(),
                                       refs["pipeline"]["forward"][n],
                                       rtol=0, atol=1e-6, err_msg=str(n))


def test_pipeline_grads_match_jax(runs):
    ranks, refs = runs
    for n in MICRO:
        want = refs["pipeline"]["grads"][n]
        for res in ranks:
            stage = res["pipeline"]["stage"]
            for name, got in res["pipeline"]["grads"][n].items():
                # each rank holds its stage's part of the stacked gradient
                np.testing.assert_allclose(got[stage].numpy(),
                                           want[name][stage], rtol=1e-5,
                                           atol=1e-5, err_msg=name)
                others = np.delete(got.numpy(), stage, axis=0)
                assert not others.any(), name


def test_pipeline_dp_pp_matches_jax(runs):
    ranks, refs = runs
    want = refs["pipeline"]["dp_pp"]
    for rank, res in enumerate(ranks):
        data = rank % 2                      # ("pipe", "data") row-major
        np.testing.assert_allclose(res["pipeline"]["dp_pp"].numpy(),
                                   want[:, 2 * data:2 * data + 2], rtol=0,
                                   atol=1e-6)


def test_pipeline_that_encoder_blocks_match_jax(runs):
    ranks, refs = runs
    for res in ranks:
        np.testing.assert_allclose(res["encoder"].numpy(), refs["encoder"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", RING_N)
def test_ring_attention_matches_jax(runs, n):
    ranks, refs = runs
    ring, full, grads = refs["ring"][n]
    part = n // RANKS
    got = [np.concatenate([r["ring"][n][i].numpy() for r in ranks], axis=2)
           for i in range(4)]
    for want in (ring, full):
        np.testing.assert_allclose(got[0], want, rtol=2e-4, atol=2e-5)
    for g, want, name in zip(got[1:], grads, "qkv"):
        np.testing.assert_allclose(g, want, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    assert got[0].shape[2] == RANKS * part


def test_dryrun_multichip_at_four_ranks(runs):
    ranks, _ = runs
    line = ranks[0]["dryrun"].strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, "
                           "'model': 2} dp+tp loss=") and line.endswith(" OK")
    assert all(not r["dryrun"] for r in ranks[1:])


def test_entry_matches_jax_entry():
    import jax
    from multi_modal_csi_tpu.core.torch_import import import_state_dict
    from multi_modal_csi_tpu.models.csi.detr import DETRMultiUser
    from multi_modal_csi_tpu_torch.entry import entry
    forward, (x,) = entry(device="cpu")
    assert x.shape == (8, 3000, 270) and x.dtype == torch.float32
    assert not x.any() and not forward.model.training
    jmodel = DETRMultiUser(token_length=10, num_decoder_layers=6,
                           temp_cross=2.0, num_queries=5, dim_feedforward=512)
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                              train=False),
        jax.ShapeDtypeStruct((1, 3000, 270), np.float32))
    variables = import_state_dict("DETR", forward.model.state_dict(), shapes)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    batch = np.random.default_rng(0).standard_normal(
        (2, 3000, 270)).astype(np.float32)
    for inputs in (x[:2].numpy(), batch):
        want = np.asarray(apply(variables, inputs))
        got = forward(torch.from_numpy(inputs)).numpy()
        assert got.shape == want.shape == (6, 2, 5, 10)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    assert forward(x).shape == (6, 8, 5, 10)
