"""One MViT-v1 training step of the port (models/video/mvit.py through
train/loop.py::make_train_step) against the JAX package's
``make_train_step(augment=False)``, on the CPU, in f32, at full width
(embed 96, 16 blocks, head dim 96) and the (1, 8, 64, 64, 3) clip of
test_torch_port_mvit.py. test_torch_port_mvit_train_v2.py does the same
for MViT-v2 with these helpers (the two files run in parallel).

Both sides start from the port's seeded weights (carried to the JAX tree
by ``tools/convert_torchvision.py::convert_mvit`` and the task head), BCE
with logits, Adam at lr 5e-4 with weight decay 2e-4, dropout and drop-path
off: the JAX model is built as ``MViT(..., dropout=0.0,
drop_path_rate=0.0)`` and the port's rates are set to 0. The step is held
to test_torch_port_train_step.py's ``compare``: the loss within 1e-5
relative, every gradient within 1e-4 of its tensor's scale (floored at
1e-2 of the model's largest), the updated parameters within 1e-6 where the
update's sign is sure in both frameworks and 2 lr + 1e-6 elsewhere. Here
fewer than 10% of the elements may be unsure (a gradient plus weight decay
of at most 1e-5 in one framework), not 5%: one clip's loss leaves many of
MViT's gradients that small, 5.9% of v1's elements and 3.8% of v2's.

Two port steps are held against the same JAX step:
- the eager attention everywhere, as both frameworks train on the CPU;
- the training gate lowered by monkeypatch, so that block 0 (1025
  queries) runs ``flash_attention_lowrank_bias_trainable``: the forward K3
  and the backward K4 in their plain versions, through the class-token
  padding of r and s, dR carried into q and the relative tables (v2) and
  the out-of-place residual (v2). Exactly one forward and one backward.
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.losses.basic import bce_with_logits as jax_bce
from multi_modal_csi_tpu.models.video import mvit as jax_mvit
from multi_modal_csi_tpu_torch.core.weights import state_dict_from_jax
from multi_modal_csi_tpu_torch.kernels import flash_attention_lowrank as LR
from multi_modal_csi_tpu_torch.losses.basic import bce_with_logits
from multi_modal_csi_tpu_torch.models.video import mvit
from multi_modal_csi_tpu_torch.nn.layers import DropPath
from multi_modal_csi_tpu_torch.runners.video import build_video_model
from test_torch_port_train_step import compare, jax_step, port_step
from tools.convert_torchvision import convert_mvit

torch.set_num_threads(1)

CLIP = (8, 64, 64)
OUT = 6
FORCED_GATE = 1024             # block 0 has 1025 queries, block 1 257
MAX_UNSURE = 0.1


def jax_reference(key):
    """(port state dict, x, y, JAX loss, new variables, gradients) of one
    JAX step from the port's seeded weights."""
    port = build_video_model(key, OUT, CLIP, seed=7)
    params, stats = convert_mvit(port.backbone.state_dict(), OUT,
                                 key[-2:].lower())
    head = port.task_head
    params["head"] = {"kernel": head.weight.detach().numpy().T,
                      "bias": head.bias.detach().numpy()}
    variables = {"params": params, "batch_stats": stats}
    # the tree carries back to the port's weights exactly
    back = state_dict_from_jax(key, variables)
    assert all(torch.equal(back[n], t) for n, t in port.state_dict().items())
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, *CLIP, 3), dtype=np.float32)
    y = (rng.random((1, OUT)) < 0.5).astype(np.float32)
    jmodel = jax_mvit.MViT(OUT, variant=key[-2:].lower(), dropout=0.0,
                           drop_path_rate=0.0)
    jloss, jnew, jgrads = jax_step(jmodel, variables, jax_bce, x, y)
    return port.state_dict(), x, y, jloss, jnew, jgrads


def port_model(key, state):
    model = build_video_model(key, OUT, CLIP)
    model.load_state_dict(state, strict=True)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = 0.0
    return model


def check_step(key, reference, monkeypatch, forced):
    """One port step, eager or with the forced gate, against the JAX
    step; returns the calls of the trainable attention and of K4."""
    state, x, y, jloss, jnew, jgrads = reference
    calls = {"trainable": 0, "backward": 0}
    real_fwd = mvit.flash_attention_lowrank_bias_trainable
    real_bwd = LR.flash_attention_lowrank_bias_backward

    def fwd(*a):
        calls["trainable"] += 1
        return real_fwd(*a)

    def bwd(*a):
        calls["backward"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(mvit, "flash_attention_lowrank_bias_trainable", fwd)
    monkeypatch.setattr(LR, "flash_attention_lowrank_bias_backward", bwd)
    if forced:
        monkeypatch.setattr(mvit, "use_train_flash",
                            lambda q: q.shape[2] >= FORCED_GATE)
    port = port_model(key, state)
    loss, before = port_step(port, bce_with_logits, x, y)
    flipped, total = compare(key, port, before, loss, jloss, jnew, jgrads,
                             max_unsure=MAX_UNSURE)
    print(f"{key} step, forced gate {forced}: loss {loss:.6f} vs "
          f"{jloss:.6f}; {flipped} of {total} parameter elements unsure")
    return calls


@pytest.fixture(scope="module")
def reference():
    return jax_reference("MViT-v1")


@pytest.mark.parametrize("forced", [False, True])
def test_mvit_v1_train_step_matches_jax(reference, monkeypatch, forced):
    calls = check_step("MViT-v1", reference, monkeypatch, forced)
    n = int(forced)
    assert calls == {"trainable": n, "backward": n}


def test_train_gate_is_the_card_at_8192_queries():
    """The training gate takes the flash path only on the card and only
    from 8192 queries; the CPU keeps the eager path at any size."""
    q = torch.zeros((1, 1, mvit.TRAIN_FLASH_MIN_QUERIES, 1))
    assert mvit.TRAIN_FLASH_MIN_QUERIES == 8192
    assert not mvit.use_train_flash(q)
