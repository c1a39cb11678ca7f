"""The port's tensor-parallel rules (parallel/partition.py) and their
execution on the shards (nn/layers.py, models/video/{swin3d,mvit}.py), on
the CPU, against the JAX package's sharded steps and the port's own one
process.

- ``partition_specs`` equals JAX's, transposed to the port's layout, for
  every parameter of DETR (``dryrun_multichip``'s shape), THAT,
  THAT_ENCODER, a tiny Swin3D and MViT-v1/v2, at a model axis of 2 and
  4: JAX's specs are carried to the port's names through the port's own
  weight map (``core/weights.py::state_dict_from_jax``) as marker arrays
  (JAX side by ``eval_shape``); a column-parallel weight's bias is sharded
  with it in the port.
- One group of 4 gloo ranks, a ("data", "model") = (2, 2) mesh, started
  once for the module, runs the rules' steps through
  ``train/loop.py::make_train_step``:
  - DETR, 6 steps (Hungarian loss, ``adam_like_torch(5e-4, 2e-4)``, JAX's
    lr), dropout and augmentation off, against JAX's step with the rules
    on a (2, 2) mesh (``tests/test_parallel.py``'s, dropout swapped for
    the identity, no augmentation) and JAX's step on one device: the
    losses within 5e-4 relative of both; the first step's gradients
    within 1e-4 of each tensor's largest of JAX's sharded step's, but for
    the depthwise conv's kernel, whose gradient JAX's sharded step
    doubles (checked: ``JAX_SHARDED_FAULTS``), held to the one-device
    step's; the parameters after the 6 steps within 1e-5 of the
    one-device run's (lr times the steps is 3e-3), an element whose
    gradient is rounding noise at some step within 2 lr a step;
  - a tiny Swin3D (``embed_dim`` 12, heads (3, 2): the first stage's 3
    heads the axis does not divide, so q, k and v are gathered there), 3
    steps of BCE at lr 1e-6 against JAX's sharded step: losses within
    1e-5 relative, the first step's gradients as DETR's, the parameters
    within 1e-7 (lr times the steps is 3e-6);
  - with dropout and augmentation on, DETR's first step against the port
    in one process on the whole batch (the loss within 1e-5 relative,
    every gradient within 1e-4 of its tensor's largest), and likewise the
    tiny Swin3D with its drop-path, MViT-v2 at full width on (2, 16, 16)
    clips (the first stage one head, gathered; K3/K4's plain versions
    forced on, as test_torch_port_mvit_train_v2.py forces them) and
    THAT_ENCODER at (1280, 90) windows (64 and 90 tokens: K1/K2's plain
    versions on the rank's heads);
  - ``average_gradients`` averages over the data axis only: a gradient
    that differs along "model" keeps each model rank's own (averaging
    over every rank, as before the rules, mixes the shards).

The ranks import this module (no JAX in them) and read their inputs from
a file the pytest process writes; the references run in the pytest
process while the ranks run.
"""

import functools
import os

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.parallel.partition import partition_specs
from test_torch_port_parallel import (join_ranks, rank_main,  # noqa: F401
                                      start_ranks)

torch.set_num_threads(1)

MODULE = "test_torch_port_tensor_parallel"
RANKS = 4
AXES = {"data": 2, "model": 2}
DETR_SHAPE, DETR_LAYERS = (8, 300, 30), 2
DETR_STEPS, SWIN_STEPS = 6, 3
DETR_LR, SWIN_LR = 5e-4, 1e-6      # JAX's (tests/test_parallel.py)
SWIN = dict(embed_dim=12, depths=(1, 1), num_heads=(3, 2), window=(2, 2, 2))
SWIN_CLIP = (4, 16, 16)
MVIT_CLIP = (2, 16, 16)
ENCODER_SHAPE = (1280, 90)
GRAD_TOL = 1e-4
# the parameters after the steps, well under lr times the steps (3e-3 and
# 3e-6), which Adam's moves add up to whatever the gradients
DETR_PARAM_TOL, SWIN_PARAM_TOL = 1e-5, 1e-7
# the cases held against the port in one process, dropout as built
ONE_PROCESS = ("detr_dropout", "swin_drop_path", "mvit", "encoder")
# JAX's sharded DETR step on a (2, 2) mesh (XLA on the CPU) returns twice
# the gradient of the depthwise conv's kernel (a grouped conv, a group a
# channel); its one-device step and the port agree. Adam divides the
# scale out but not the weight decay added to it, so that kernel drifts
# from the one-device run's: it is held to JAX's one-device run.
JAX_SHARDED_FAULTS = ("feature_extractor.initial_conv.depthwise.weight",)


# ---------------------------------------------------------------------- #
# the spec table against JAX's, no process group
# ---------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def _jax_shapes(key):
    """(JAX's variables' shapes by ``eval_shape``, the weight map's
    arguments) of ``key``."""
    import jax
    jmodel, shape, kwargs = _jax_models()[key]
    return jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                              train=False),
        jax.ShapeDtypeStruct(shape, np.float32)), kwargs


def _jax_models():
    from multi_modal_csi_tpu.models.csi.detr import DETRMultiUser
    from multi_modal_csi_tpu.models.csi.that import THAT
    from multi_modal_csi_tpu.models.csi.that_encoder import THATEncoderDETR
    from multi_modal_csi_tpu.models.video.mvit import mvit_v1_b, mvit_v2_s
    from multi_modal_csi_tpu.models.video.swin3d import Swin3D
    return {
        "DETR": (DETRMultiUser(token_length=10, num_decoder_layers=2,
                               num_queries=5, dim_feedforward=64),
                 (1, 300, 30), dict(num_decoder_layers=2)),
        "THAT": (THAT(out_features=54), (1, 3000, 270), {}),
        "THAT_ENCODER": (THATEncoderDETR(), (1, 3000, 270), {}),
        "Swin-T": (Swin3D(6, drop_path_rate=0.0, **SWIN),
                   (1, *SWIN_CLIP, 3), {}),
        "MViT-v1": (mvit_v1_b(6), (1, 4, 32, 32, 3), {}),
        "MViT-v2": (mvit_v2_s(6), (1, 4, 32, 32, 3), {}),
    }


@pytest.mark.parametrize("model_par", [2, 4])
@pytest.mark.parametrize("key", ["DETR", "THAT", "THAT_ENCODER", "Swin-T",
                                 "MViT-v1", "MViT-v2"])
def test_partition_specs_match_jax(key, model_par):
    import jax
    from jax.sharding import PartitionSpec as P
    from multi_modal_csi_tpu.parallel.mesh import create_mesh
    from multi_modal_csi_tpu.parallel.partition import (
        partition_specs as jax_specs)

    shapes, kwargs = _jax_shapes(key)
    mesh = create_mesh({"data": 8 // model_par, "model": model_par},
                       devices=jax.devices()[:8])
    codes = {P(): 0, P(None, "model"): 1, P("model", None): 2}
    specs = jax_specs(shapes["params"], mesh)
    markers = {
        "params": jax.tree_util.tree_map(
            lambda s, leaf: np.full(leaf.shape, codes[s], np.int8), specs,
            shapes["params"], is_leaf=lambda s: isinstance(s, P)),
        "batch_stats": jax.tree_util.tree_map(
            lambda leaf: np.zeros(leaf.shape, np.int8),
            shapes.get("batch_stats", {}))}
    carried = state_dict_from_jax(key, markers, **kwargs)
    code = {}
    for name, t in carried.items():
        lo, hi = int(t.min()), int(t.max())
        assert lo == hi, (name, lo, hi)
        code[name] = lo
    want = {name: ((), ("model", None), (None, "model"))[c]
            for name, c in code.items()}
    for name in want:              # a column weight's bias goes with it
        weight = (name[:-len("in_proj_bias")] + "in_proj_weight"
                  if name.endswith("in_proj_bias") else
                  name[:-len("bias")] + "weight"
                  if name.endswith(".bias") else None)
        if code.get(weight) == 1:
            want[name] = ("model",)
    got = partition_specs({n: tuple(t.shape) for n, t in carried.items()},
                          {"data": 8 // model_par, "model": model_par})
    assert got == want
    if model_par == 2:              # every attention and FFN/MLP pair
        columns = sum(c == 1 for c in code.values())
        assert columns and columns == sum(c == 2 for c in code.values())


# ---------------------------------------------------------------------- #
# 4 ranks: the rules' steps against JAX and against one process
# ---------------------------------------------------------------------- #

def detr_port():
    from multi_modal_csi_tpu_torch.models.csi import DETRMultiUser
    return DETRMultiUser(10, DETR_LAYERS, 1.0, 5, 64, length=DETR_SHAPE[1],
                         channels=DETR_SHAPE[2],
                         generator=torch.Generator().manual_seed(0))


def swin_port():
    from multi_modal_csi_tpu_torch.models.video import Swin3D
    return Swin3D(6, SWIN_CLIP, generator=torch.Generator().manual_seed(0),
                  **SWIN)


def mvit_port():
    from multi_modal_csi_tpu_torch.models.video import mvit_v2_s
    return mvit_v2_s(6, MVIT_CLIP, generator=torch.Generator().manual_seed(3))


def encoder_port():
    from multi_modal_csi_tpu_torch.models.csi.that_encoder import (
        THATEncoderDETR)
    return THATEncoderDETR(2.0, 5, 2, length=ENCODER_SHAPE[0],
                           channels=ENCODER_SHAPE[1],
                           generator=torch.Generator().manual_seed(4))


def no_dropout(model):
    from multi_modal_csi_tpu_torch.nn import layers as L
    for m in model.modules():
        if isinstance(m, L.Dropout):
            m.p = 0.0
        elif isinstance(m, L.MultiheadAttention):
            m.dropout = 0.0
        elif isinstance(m, L.DropPath):
            m.rate = 0.0
    return model


def whole(model, grads=False):
    """Every parameter (or gradient) of ``model``, whole (a DTensor's
    shards gathered), as numpy, by name."""
    from multi_modal_csi_tpu_torch.parallel.partition import full_tensor
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p.detach()
        if t is not None:
            out[name] = full_tensor(t).detach().numpy().copy()
    return out


def run_steps(model, loss_fn, x, y, steps, *, lr, weight_decay=0.0,
              augment=False, mesh=None, seed=1):
    """``steps`` of make_train_step on ``model`` (this rank's rows of x
    and y with ``mesh``): the global losses, the whole gradients of the
    first step and the whole parameters after the last (gathered on every
    rank, returned by rank 0 alone: the others' are the same)."""
    from multi_modal_csi_tpu_torch.parallel.collectives import (axis_scope,
                                                                pmean)
    from multi_modal_csi_tpu_torch.parallel.mesh import (batch_sharding,
                                                         shard_batch)
    from multi_modal_csi_tpu_torch.train.loop import (adam_like_torch,
                                                      make_train_step)
    sharding = None if mesh is None else batch_sharding(mesh)
    step = make_train_step(model, adam_like_torch(model.parameters(), lr,
                                                  weight_decay),
                           loss_fn, augment=augment, sharding=sharding)
    bx, by = (torch.from_numpy(shard_batch(sharding, a)) for a in (x, y))
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for i in range(steps):
        loss, _ = step(bx, by, gen)
        with axis_scope(mesh):
            losses.append(float(pmean(loss, "data")))
        if i == 0:
            grads = whole(model, grads=True)
    params = whole(model)
    if mesh is not None and torch.distributed.get_rank():
        return {"losses": losses}
    return {"losses": losses, "grads": grads, "params": params}


def mvit_loss(out, y):
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    return bce_with_logits(out, y)


def forced_flash(monkeypatch=None):
    """Lower MViT's training gate to every block (K3/K4's plain versions
    on the CPU), as test_torch_port_mvit_train_v2.py does."""
    from multi_modal_csi_tpu_torch.models.video import mvit
    if monkeypatch is None:
        mvit.use_train_flash = lambda q: True
    else:
        monkeypatch.setattr(mvit, "use_train_flash", lambda q: True)


def cases(inputs):
    """(name, model builder, loss, x, y, steps, settings) of every step
    the ranks run and the pytest process holds them against."""
    from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
    from multi_modal_csi_tpu_torch.losses.matching import (
        HungarianMatchingLoss)

    def detr(dropout=False):
        model = detr_port()
        model.load_state_dict(inputs["detr_state"], strict=True)
        return model if dropout else no_dropout(model)

    def swin(drop_path=False):
        model = swin_port()
        model.load_state_dict(inputs["swin_state"], strict=True)
        return model if drop_path else no_dropout(model)

    hungarian = HungarianMatchingLoss()
    encoder_loss = HungarianMatchingLoss(per_layer_matching=True)
    return {
        "detr": (detr, hungarian, inputs["detr_x"], inputs["detr_y"],
                 DETR_STEPS, dict(lr=DETR_LR, weight_decay=2e-4)),
        "swin": (swin, bce_with_logits, inputs["swin_x"], inputs["swin_y"],
                 SWIN_STEPS, dict(lr=SWIN_LR)),
        "detr_dropout": (lambda: detr(True), hungarian, inputs["detr_x"],
                         inputs["detr_y"], 1,
                         dict(lr=DETR_LR, weight_decay=2e-4, augment=True)),
        "swin_drop_path": (lambda: swin(True), bce_with_logits,
                           inputs["swin_x"], inputs["swin_y"], 1,
                           dict(lr=1e-4)),
        "mvit": (mvit_port, mvit_loss, inputs["mvit_x"], inputs["mvit_y"],
                 1, dict(lr=1e-4)),
        "encoder": (encoder_port, encoder_loss, inputs["enc_x"],
                    inputs["enc_y"], 1,
                    dict(lr=1e-4, weight_decay=2e-4, augment=True)),
    }


def average_gradients_check(mesh, rank):
    """Each rank's gradient: its model index plus 10 times its data index;
    the mean over "data" keeps the model index."""
    from multi_modal_csi_tpu_torch.parallel.collectives import (
        average_gradients, axis_index, axis_scope)
    p = torch.nn.Parameter(torch.zeros(3))
    with axis_scope(mesh):
        p.grad = torch.full((3,), axis_index("model")
                            + 10.0 * axis_index("data"))
        average_gradients([p], "data")
        return p.grad.clone(), axis_index("model")


def ranks_main(rank, world, inputs_path):
    from multi_modal_csi_tpu_torch.parallel.mesh import create_mesh
    from multi_modal_csi_tpu_torch.parallel.partition import (
        apply_tensor_parallel)
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = create_mesh(dict(AXES))
    forced_flash()
    res = {"average": average_gradients_check(mesh, rank)}
    for name, (build, loss_fn, x, y, steps, kw) in cases(inputs).items():
        model = apply_tensor_parallel(build(), mesh)
        res[name] = run_steps(model, loss_fn, x, y, steps, mesh=mesh, **kw)
        res[name]["placed"] = sorted(
            n for n, p in model.named_parameters()
            if type(p.data).__name__ == "DTensor")
    return res


class _NoDropout:
    """Stands in for flax.linen.Dropout: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def on_mesh(tree, mesh):
    """Every array of ``tree`` on ``mesh``: as placed where it is, else
    replicated (Adam's step count, the BatchNorm statistics)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(a):
        if isinstance(getattr(a, "sharding", None), NamedSharding):
            return a
        return jax.device_put(a, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, tree)


def same_placement(step, state, mesh):
    """``jax.jit(step)`` returning the state placed as it came in (the
    rules' placement, JAX's ``sharding_tree``), the loss replicated and the
    gradients placed as the parameters, so that the step compiles once,
    not again for the placement its first call returns."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    placed = jax.tree_util.tree_map(lambda a: a.sharding, state)
    return jax.jit(step, out_shardings=(*placed, NamedSharding(mesh, P()),
                                        placed[0]))


def jax_detr_run(variables, x, y, sharded=True):
    """JAX's DETR step with the rules on a (2, 2) mesh (or, ``sharded``
    False, on one device), tests/test_parallel.py's, without dropout and
    augmentation: the losses, the last state and every step's
    gradients."""
    import jax
    import optax
    from jax.sharding import NamedSharding
    from multi_modal_csi_tpu.losses.matching import HungarianMatchingLoss
    from multi_modal_csi_tpu.models.csi.detr import DETRMultiUser
    from multi_modal_csi_tpu.parallel.mesh import batch_sharding, create_mesh
    from multi_modal_csi_tpu.parallel.partition import (
        partition_specs as jax_specs)
    from multi_modal_csi_tpu.train.loop import adam_like_torch

    model = DETRMultiUser(token_length=10, num_decoder_layers=DETR_LAYERS,
                          num_queries=5, dim_feedforward=64)
    tx = adam_like_torch(DETR_LR, 2e-4)
    loss_obj = HungarianMatchingLoss()
    batch_stats = variables["batch_stats"]

    def train_step(params, batch_stats, opt_state, bx, by):
        def loss_wrap(p):
            out, mut = model.apply(
                {"params": p, "batch_stats": batch_stats}, bx, train=True,
                mutable=["batch_stats"])
            return loss_obj(out, by), mut

        (loss, mut), grads = jax.value_and_grad(loss_wrap,
                                                has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), mut["batch_stats"],
                opt_state, loss, grads)

    params = variables["params"]
    if sharded:
        mesh = create_mesh(dict(AXES), devices=jax.devices()[:RANKS])
        params = jax.tree_util.tree_map(
            lambda leaf, s: jax.device_put(leaf, NamedSharding(mesh, s)),
            params, jax_specs(params, mesh))
        state = on_mesh((params, batch_stats, tx.init(params)), mesh)
        bx = jax.device_put(x, batch_sharding(mesh, 3))
        by = jax.device_put(y, batch_sharding(mesh, 3))
        train_step = same_placement(train_step, state, mesh)
    else:
        state, bx, by = (params, batch_stats, tx.init(params)), x, y
        train_step = jax.jit(train_step)
    params, batch_stats, opt_state = state
    losses, grads = [], []
    for _ in range(DETR_STEPS):
        params, batch_stats, opt_state, loss, g = train_step(
            params, batch_stats, opt_state, bx, by)
        losses.append(float(loss))
        grads.append(jax.device_get(g))
    return losses, {"params": jax.device_get(params),
                    "batch_stats": jax.device_get(batch_stats)}, grads


def jax_swin_run(variables, x, y):
    """JAX's Swin3D step with the rules on a (2, 2) mesh,
    tests/test_parallel.py's."""
    import jax
    import jax.numpy as jnp
    import optax
    from multi_modal_csi_tpu.models.video.swin3d import Swin3D
    from multi_modal_csi_tpu.parallel.mesh import batch_sharding, create_mesh
    from multi_modal_csi_tpu.parallel.partition import shard_params

    model = Swin3D(6, drop_path_rate=0.0, **SWIN)
    tx = optax.adam(SWIN_LR)

    def train_step(params, opt_state, bx, by):
        def loss_fn(p):
            logits = model.apply({"params": p}, bx, train=False)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(logits, by))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    mesh = create_mesh(dict(AXES), devices=jax.devices()[:RANKS])
    params = shard_params(variables["params"], mesh)
    state = on_mesh((params, tx.init(params)), mesh)
    params, opt_state = state
    bx = jax.device_put(x, batch_sharding(mesh, 5))
    by = jax.device_put(y, batch_sharding(mesh, 2))
    train_step = same_placement(train_step, state, mesh)
    losses, grads = [], []
    for _ in range(SWIN_STEPS):
        params, opt_state, loss, g = train_step(params, opt_state, bx, by)
        losses.append(float(loss))
        grads.append(jax.device_get(g))
    return losses, {"params": jax.device_get(params)}, grads


def make_inputs():
    """The port's seeded weights as JAX variables (JAX's own importers:
    ``core/torch_import.py`` for DETR, perturbed as
    test_torch_port_train_step.py perturbs them, and
    ``tools/convert_torchvision.py`` for Swin3D), the port's state dicts
    carried back from them, and every batch."""
    import jax
    from multi_modal_csi_tpu.core.torch_import import import_state_dict
    from multi_modal_csi_tpu.models.csi.detr import DETRMultiUser
    from test_torch_port_layers import perturb
    from tools.convert_torchvision import convert_swin3d
    rng = np.random.default_rng(0)
    detr = DETRMultiUser(token_length=10, num_decoder_layers=DETR_LAYERS,
                         num_queries=5, dim_feedforward=64)
    shapes = jax.eval_shape(
        lambda x: detr.init({"params": jax.random.PRNGKey(0)}, x,
                            train=False),
        jax.ShapeDtypeStruct((1,) + DETR_SHAPE[1:], np.float32))
    detr_vars = perturb(import_state_dict(
        "DETR", detr_port().state_dict(), shapes), 1)
    swin = swin_port()
    params, stats = convert_swin3d(swin.backbone.state_dict(), 6,
                                   depths=SWIN["depths"])
    params["head"] = {"kernel": swin.task_head.weight.detach().numpy().T,
                      "bias": swin.task_head.bias.detach().numpy()}
    swin_vars = {"params": params, "batch_stats": stats}
    detr_y = np.zeros((DETR_SHAPE[0], 5, 10), np.float32)
    detr_y[:, :2] = np.eye(10, dtype=np.float32)[
        rng.integers(0, 9, (DETR_SHAPE[0], 2))]
    detr_y[:, 2:, -1] = 1.0
    enc_y = np.zeros((4, 5, 10), np.float32)
    enc_y[:, :2] = np.eye(10, dtype=np.float32)[rng.integers(0, 9, (4, 2))]
    enc_y[:, 2:, -1] = 1.0
    return {
        "detr_vars": detr_vars, "swin_vars": swin_vars,
        "detr_state": state_dict_from_jax("DETR", detr_vars,
                                          num_decoder_layers=DETR_LAYERS),
        "swin_state": state_dict_from_jax("Swin-T", swin_vars),
        "detr_x": rng.normal(size=DETR_SHAPE).astype(np.float32),
        "detr_y": detr_y,
        "swin_x": rng.normal(size=(8, *SWIN_CLIP, 3)).astype(np.float32),
        "swin_y": (rng.random((8, 6)) > 0.5).astype(np.float32),
        "mvit_x": rng.normal(size=(4, *MVIT_CLIP, 3)).astype(np.float32),
        "mvit_y": (rng.random((4, 6)) > 0.5).astype(np.float32),
        "enc_x": rng.normal(size=(4, *ENCODER_SHAPE)).astype(np.float32),
        "enc_y": enc_y,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, JAX's sharded runs and the port's one-process
    runs (the dropout-on cases)."""
    import flax.linen
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inputs = make_inputs()
    path = os.path.join(str(tmp), "inputs.pt")
    torch.save({k: v for k, v in inputs.items() if not k.endswith("_vars")},
               path)
    procs = start_ranks(MODULE, f"{MODULE}:ranks_main", tmp, ranks=RANKS,
                        kwargs={"inputs_path": path})
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        forced_flash(mp)
        refs = {"jax_detr": jax_detr_run(inputs["detr_vars"],
                                         inputs["detr_x"], inputs["detr_y"]),
                "jax_detr_one": jax_detr_run(
                    inputs["detr_vars"], inputs["detr_x"], inputs["detr_y"],
                    sharded=False),
                "jax_swin": jax_swin_run(inputs["swin_vars"],
                                         inputs["swin_x"], inputs["swin_y"])}
        for name, (build, loss_fn, x, y, steps, kw) in cases(inputs).items():
            if name in ONE_PROCESS:
                refs[name] = run_steps(build(), loss_fn, x, y, steps, **kw)
    finally:
        mp.undo()
        ranks = join_ranks(procs, tmp)
    return ranks, refs, inputs


def test_average_gradients_over_the_data_axis_only(runs):
    ranks, _, _ = runs
    for res in ranks:
        grad, model_index = res["average"]
        np.testing.assert_array_equal(grad.numpy(),
                                      np.full(3, model_index + 5.0))


def carried(key, tree, stats=None):
    """A JAX tree laid out as the parameters (the parameters, or their
    gradients) carried to the port's names, as numpy."""
    sd = state_dict_from_jax(
        key, {"params": tree, "batch_stats": stats or {}},
        **({"num_decoder_layers": DETR_LAYERS} if key == "DETR" else {}))
    return {name: t.numpy() for name, t in sd.items()}


def grad_bounds(grads):
    """Each tensor's bound: GRAD_TOL of its largest value, and at least
    GRAD_TOL of a hundredth of the largest of all."""
    scale = max(np.abs(g).max() for g in grads.values())
    return {name: GRAD_TOL * max(np.abs(g).max(), 1e-2 * scale)
            for name, g in grads.items()}


def assert_grads_close(got, want, bounds=None):
    bounds = grad_bounds(want) if bounds is None else bounds
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=bounds[name],
                                   err_msg=name)


def assert_params_close(res, key, jax_run, *, param_tol, lr, steps):
    """The port's parameters after its last step (``res``) against a JAX
    run's: every element within ``param_tol``, except where JAX's
    gradient of that element lies within its tensor's ``grad_bounds`` of
    zero at some step. Adam moves an element by about lr a step whatever
    its gradient's size, so the sign of such a gradient (rounding decides
    it: a conv bias before a BatchNorm has a gradient of rounding noise)
    may move the element lr either way, and such an element is held to
    2 lr a step."""
    _, tree, grads = jax_run
    stats = tree.get("batch_stats")
    want_grads = [carried(key, g, stats) for g in grads]
    bounds = [grad_bounds(g) for g in want_grads]
    want = carried(key, tree["params"], stats)
    for name, got in res["params"].items():
        diff = np.abs(got - want[name])
        noise = np.zeros(got.shape, bool)
        for g, b in zip(want_grads, bounds):
            noise |= np.abs(g[name]) <= b[name]
        off = (diff > param_tol) & ~noise
        assert not off.any(), (
            f"{name}: {int(off.sum())} elements off by up to "
            f"{diff[off].max():.3e} with gradients above the noise")
        assert diff.max() <= 2 * lr * steps, (name, diff.max())


def test_detr_steps_match_jax_sharded_step(runs):
    ranks, refs, _ = runs
    sharded, one = refs["jax_detr"], refs["jax_detr_one"]
    for res in ranks:
        assert res["detr"]["placed"], "the rules placed nothing"
        for jax_run in (sharded, one):
            np.testing.assert_allclose(res["detr"]["losses"], jax_run[0],
                                       rtol=5e-4)
    port = ranks[0]["detr"]
    stats = sharded[1]["batch_stats"]
    g_sharded, g_one = (carried("DETR", run[2][0], stats)
                        for run in (sharded, one))
    bounds = grad_bounds(g_one)
    for name in port["grads"]:
        # JAX's fault is what JAX_SHARDED_FAULTS says: its sharded
        # gradient twice its one-device gradient there, the same elsewhere
        factor = 2.0 if name in JAX_SHARDED_FAULTS else 1.0
        np.testing.assert_allclose(g_sharded[name], factor * g_one[name],
                                   rtol=0, atol=factor * bounds[name],
                                   err_msg=name)
    # the port's first step against JAX's sharded step, the faulty kernel
    # against the one-device step
    assert_grads_close(port["grads"], {
        name: g_one[name] if name in JAX_SHARDED_FAULTS else g_sharded[name]
        for name in port["grads"]}, bounds)
    # the trajectory after 6 steps against JAX's one-device run: the
    # sharded run's drifts with its faulty kernel
    assert_params_close(port, "DETR", one, param_tol=DETR_PARAM_TOL,
                        lr=DETR_LR, steps=DETR_STEPS)


def test_swin3d_steps_match_jax_sharded_step(runs):
    ranks, refs, _ = runs
    losses, tree, grads = refs["jax_swin"]
    for res in ranks:
        r = res["swin"]
        # the first stage's qkv (3 heads, gathered) is sharded too
        assert "backbone.features.0.0.attn.qkv.weight" in r["placed"]
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    port = ranks[0]["swin"]
    assert_grads_close(port["grads"], carried("Swin-T", grads[0]))
    assert_params_close(port, "Swin-T", refs["jax_swin"],
                        param_tol=SWIN_PARAM_TOL, lr=SWIN_LR,
                        steps=SWIN_STEPS)


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_steps_match_one_process(runs, name):
    ranks, refs, _ = runs
    want = refs[name]
    for res in ranks:
        assert res[name]["placed"], "the rules placed nothing"
        np.testing.assert_allclose(res[name]["losses"], want["losses"],
                                   rtol=1e-5)
    got = ranks[0][name]["grads"]
    assert got.keys() == want["grads"].keys()
    assert_grads_close(got, want["grads"])
