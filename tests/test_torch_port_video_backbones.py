"""The port's ResNet3D-18 (models/video/resnet3d.py) against the JAX
package's on the CPU, and the helpers with which
test_torch_port_video_backbones_swin.py and
test_torch_port_video_backbones_s3d.py hold Swin3D and S3D (the three
files run in parallel).

Each model pair shares the port's seeded weights, carried into the JAX tree
by the JAX package's own converters (``tools/convert_torchvision.py::
convert_r3d_18``, ``convert_s3d``, ``convert_swin3d``) plus the task head.
ResNet runs at full width on (2, 4, 32, 32, 3) clips. Swin runs narrowed
(``embed_dim`` 8, heads of 4 values, window (2, 3, 3)) on (2, 5, 36, 8, 3)
clips, which pad T to the patch, pad T and W to the window, clip W's
window, shift T and H, and merge an odd H: "Swin-T" with depths (2, 2),
"Swin-S" with depths (2, 2, 2).

Tolerances:
- f32 forward, eval and train mode (dropout and drop-path off on both
  sides): the logits within 1e-4 of the largest logit; the running
  statistics moved by the train-mode forward within 1e-5 of each tensor's
  largest magnitude (at least 1);
- one training step (BCE with logits, as the video engine trains), against
  ``jax.value_and_grad`` of JAX's apply in train mode: the loss within 1e-4
  relative, each gradient within 1e-4 of its tensor's largest magnitude
  (floored at 1e-2 of the model's largest gradient);
- bf16 serving (both packages' ``cast_for_serving``, the clip cast to
  bf16): the port within twice JAX's own bf16 error (its bf16 logits
  against its f32 ones, the largest difference) of JAX's bf16 logits;
- ``load_video_pretrained`` of one torchvision-layout file
  (``tools/torch_video_refs.py``'s replicas' state dicts, with
  torchvision's ``num_batches_tracked`` and ``relative_position_index``
  buffers, and S3D's 1x1x1 classifier conv) in both packages: the same
  weights bit for bit, the same fresh task head.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.models.video import resnet3d as jax_resnet
from multi_modal_csi_tpu.models.video import s3d as jax_s3d
from multi_modal_csi_tpu.models.video import swin3d as jax_swin
from multi_modal_csi_tpu.runners import video as jax_video
from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.models import video as V
from multi_modal_csi_tpu_torch.nn.layers import Dropout, DropPath
from multi_modal_csi_tpu_torch.runners import video
from multi_modal_csi_tpu_torch.train.loop import cast_for_serving
from tools import convert_torchvision as C
from tools import torch_video_refs as R

torch.set_num_threads(1)

OUT = 6
LOGIT_TOL = 1e-4
STATS_TOL = 1e-5
GRAD_TOL = 1e-4
SWIN = {"embed_dim": 8, "num_heads": (2, 4, 8), "window": (2, 3, 3)}
SWIN_DEPTHS = {"Swin-T": (2, 2), "Swin-S": (2, 2, 2)}
CLIPS = {"ResNet": (4, 32, 32), "S3D": (8, 96, 96), "Swin-T": (5, 36, 8),
         "Swin-S": (5, 36, 8)}


def models(key):
    """(port model, JAX model) of ``key`` at this file's sizes, with
    dropout and drop-path off in both."""
    g = torch.Generator().manual_seed(11)
    clip = CLIPS[key]
    if key == "ResNet":
        return V.ResNet3D18(OUT, clip, generator=g), jax_resnet.ResNet3D18(OUT)
    if key == "S3D":
        port = V.S3D(OUT, clip, generator=g)
        return port, jax_s3d.S3D(OUT, dropout=0.0)
    depths = SWIN_DEPTHS[key]
    heads = SWIN["num_heads"][:len(depths)]
    port = V.Swin3D(OUT, clip, embed_dim=SWIN["embed_dim"], depths=depths,
                    num_heads=heads, window=SWIN["window"], generator=g)
    return port, jax_swin.Swin3D(OUT, embed_dim=SWIN["embed_dim"],
                                 depths=depths, num_heads=heads,
                                 window=SWIN["window"], drop_path_rate=0.0)


def jax_variables(key, port):
    """The port's weights as the JAX tree, through the JAX converters."""
    sd = port.backbone.state_dict()
    if key == "ResNet":
        params, stats = C.convert_r3d_18(sd, OUT)
    elif key == "S3D":
        params, stats = C.convert_s3d(sd, OUT)
    else:
        params, stats = C.convert_swin3d(sd, OUT, depths=SWIN_DEPTHS[key])
    head = port.task_head
    params["head"] = {"kernel": head.weight.detach().numpy().T,
                      "bias": head.bias.detach().numpy()}
    return {"params": params, "batch_stats": stats}


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
        if isinstance(m, DropPath):
            m.rate = 0.0
    return model


def data(key, n=2, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *CLIPS[key], 3)).astype(np.float32)
    y = (rng.random((n, OUT)) < 0.5).astype(np.float32)
    return x, y


class Pair:
    """A port model, the JAX model with the same weights, and JAX's
    results, each computed once."""

    def __init__(self, key):
        self.key = key
        self.port, self.jmodel = models(key)
        no_dropout(self.port)
        self.variables = jax_variables(key, self.port)
        # the tree carries back to the port's weights exactly
        back = state_dict_from_jax(key, self.variables)
        assert all(torch.equal(back[n], t)
                   for n, t in self.port.state_dict().items())
        self.x, self.y = data(key)
        self._eval = self._train = None

    def jax_eval(self):
        if self._eval is None:
            self._eval = np.asarray(jax.jit(lambda v, x: self.jmodel.apply(
                v, x, train=False))(self.variables, jnp.asarray(self.x)))
        return self._eval

    def jax_train(self):
        """(loss, logits, gradients, moved statistics) of one train-mode
        forward and backward in JAX."""
        if self._train is None:
            jmodel, stats = self.jmodel, self.variables["batch_stats"]

            def loss_fn(params, x, y):
                logits, moved = jmodel.apply(
                    {"params": params, "batch_stats": stats}, x, train=True,
                    mutable=["batch_stats"])
                return jax_bce(logits, y), (logits, moved["batch_stats"]
                                            if "batch_stats" in moved
                                            else {})

            (loss, (logits, moved)), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(self.variables["params"],
                                        jnp.asarray(self.x),
                                        jnp.asarray(self.y))
            as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
            self._train = (float(loss), np.asarray(logits), as_np(grads),
                           as_np(moved))
        return self._train


def assert_logits(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def check_forward(pair, mode):
    port = pair.port
    if mode == "eval":
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(pair.x)).numpy()
        assert_logits(got, pair.jax_eval())
        return
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(pair.x)).numpy()
        moved = {k: v.clone() for k, v in port.state_dict().items()}
    finally:
        port.load_state_dict(before)
        port.eval()
    _, logits, _, jmoved = pair.jax_train()
    assert_logits(got, logits)
    want = state_dict_from_jax(pair.key, {
        "params": pair.variables["params"], "batch_stats": jmoved})
    stats = [k for k in moved if k.endswith(("running_mean", "running_var"))]
    assert bool(stats) == (pair.key in ("ResNet", "S3D"))
    for name in stats:
        w = want[name].numpy()
        assert not np.array_equal(w, before[name].numpy()), name
        np.testing.assert_allclose(
            moved[name].numpy(), w, rtol=0,
            atol=STATS_TOL * max(1.0, np.abs(w).max()), err_msg=name)


def check_step(pair):
    port = pair.port
    before = {k: v.clone() for k, v in port.state_dict().items()}
    port.train()
    port.zero_grad(set_to_none=True)
    try:
        loss = bce_with_logits(port(torch.from_numpy(pair.x)),
                               torch.from_numpy(pair.y))
        loss.backward()
        loss = float(loss)
        grads = {n: p.grad.numpy().copy()
                 for n, p in port.named_parameters()}
    finally:
        port.zero_grad(set_to_none=True)
        port.load_state_dict(before)
        port.eval()
    jloss, _, jgrads, jmoved = pair.jax_train()
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    want = state_dict_from_jax(pair.key, {"params": jgrads,
                                          "batch_stats": jmoved})
    assert set(grads) <= set(want)
    floor = 1e-2 * max(np.abs(want[n].numpy()).max() for n in grads)
    for name, g in grads.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), floor),
            err_msg=name)


def check_bf16(pair):
    params = jax_cast(pair.variables, jnp.bfloat16)
    jf = jax.jit(lambda v, x: pair.jmodel.apply(v, x, train=False))
    want = np.asarray(jf(params, jnp.asarray(pair.x, jnp.bfloat16)),
                      dtype=np.float32)
    jax_err = np.abs(want - pair.jax_eval()).max()
    port = cast_for_serving(copy.deepcopy(pair.port), torch.bfloat16).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pair.x).to(torch.bfloat16)).float()
    err = np.abs(got.numpy() - want).max()
    print(f"{pair.key} bf16: port vs JAX {err:.4g}, JAX bf16 vs f32 "
          f"{jax_err:.4g}")
    assert jax_err > 0 and err <= 2 * jax_err


def torchvision_file(key, tmp_path):
    """A torchvision-layout state dict of ``key``'s backbone, from the
    replicas (Swin narrowed in width only: JAX's loader converts
    (2, 2, 6, 2) or (2, 2, 18, 2) blocks), and the port model and JAX
    model it loads into."""
    g = torch.Generator().manual_seed(2)
    clip = CLIPS[key]
    if key == "ResNet":
        ref, port = R.R3D18Ref(), V.ResNet3D18(OUT, clip, generator=g)
        jmodel = jax_resnet.ResNet3D18(OUT)
    elif key == "S3D":
        ref, port = R.S3DRef(), V.S3D(OUT, clip, generator=g)
        jmodel = jax_s3d.S3D(OUT)
    else:
        depths = (2, 2, 6, 2) if key == "Swin-T" else (2, 2, 18, 2)
        width = {"embed_dim": 8, "num_heads": (1, 2, 4, 8)}
        ref = R.Swin3DRef(depths=depths, **width)
        port = V.Swin3D(OUT, clip, depths=depths, generator=g, **width)
        jmodel = jax_swin.Swin3D(OUT, depths=depths, **width)
    torch.manual_seed(3)
    with torch.no_grad():
        for t in ref.state_dict().values():
            if t.is_floating_point():
                t.normal_()
    path = str(tmp_path / f"{key}.pth")
    torch.save(ref.state_dict(), path)
    return path, port, jmodel


def check_pretrained(key, tmp_path):
    path, port, jmodel = torchvision_file(key, tmp_path)
    x = np.zeros((1, *CLIPS[key], 3), np.float32)
    v0 = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    params, stats = jax_video.load_video_pretrained(path, key, OUT, v0,
                                                    x.shape)
    want = state_dict_from_jax(key, {"params": params,
                                     "batch_stats": stats})
    got = video.load_video_pretrained(path, key, port).state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        assert torch.equal(value, want[name]), name


@pytest.fixture(scope="module")
def pair():
    return Pair("ResNet")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_matches_jax(pair, mode):
    check_forward(pair, mode)


def test_train_step_matches_jax(pair):
    check_step(pair)


def test_bf16_serving_matches_jax(pair):
    check_bf16(pair)


def test_load_video_pretrained_matches_jax(tmp_path):
    check_pretrained("ResNet", tmp_path)
