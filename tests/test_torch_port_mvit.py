"""The port's MViT-v1 and MViT-v2 (multi_modal_csi_tpu_torch.models.video.
mvit) on the CPU against the JAX package's, at full width (embed 96, 16
blocks, stages (1, 2, 11, 2), head dim 96) and a (1, 8, 64, 64, 3) clip.

At that clip stage 1 has 1025 queries and stage 2 257: JAX on the CPU runs
K3 in interpret mode for 256 <= nq <= 1024 and its eager path elsewhere,
the port runs K3's plain version wherever nq >= 256; both compute the same
function. The JAX weights go through ``state_dict_from_jax`` and a strict
load. Tolerances: f32 logits 1e-4 (absolute and relative); bf16 serving
(both sides cast once and serve bf16) within 2% of the largest f32 logit,
as for the CSI models, since the two frameworks round bf16 at other places
(XLA rounds the GELU's intermediate steps, PyTorch once). The weight maps
are checked in both directions: the port's backbone through the JAX
package's ``convert_mvit`` gives the JAX tree back exactly, and the
torchvision-keyed ``MViTRef`` state dict loads strictly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.models.video import mvit as jax_mvit
from multi_modal_csi_tpu.train.loop import cast_for_serving as jax_cast
from multi_modal_csi_tpu_torch.core import weights
from multi_modal_csi_tpu_torch.core.serving import VideoServer
from multi_modal_csi_tpu_torch.core.weights import (resize_mvit_tables,
                                                    state_dict_from_jax)
from multi_modal_csi_tpu_torch.models.video import mvit
from multi_modal_csi_tpu_torch.runners.video import build_video_model
from tools.convert_torchvision import convert_mvit
from tools.convert_torchvision import resize_mvit_tables as tools_resize
from tools.torch_video_refs import MViTRef

torch.set_num_threads(1)

CLIP = (8, 64, 64)
OUT = 6
F32_TOL = 1e-4
BF16_SHARE = 0.02
VARIANTS = {"MViT-v1": "v1", "MViT-v2": "v2"}


def clips(n=1, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, *CLIP, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_run(request):
    """(key, JAX variables as numpy, f32 logits, bf16-serving logits)."""
    key = request.param
    jmodel = jax_mvit.MViT(OUT, variant=VARIANTS[key])
    x = jnp.asarray(clips())
    variables = jmodel.init({"params": jax.random.PRNGKey(1)}, x,
                            train=False)
    f32 = np.asarray(jmodel.apply(variables, x, train=False))
    bf16 = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x.astype(jnp.bfloat16), train=False).astype(jnp.float32))(
            jax_cast(variables, jnp.bfloat16), x))
    return key, jax.tree_util.tree_map(np.asarray, variables), f32, bf16


def port_from_jax(key, variables):
    port = build_video_model(key, OUT, CLIP)
    port.load_state_dict(state_dict_from_jax(key, variables), strict=True)
    return port


def test_f32_logits_match_jax(jax_run):
    key, variables, want, _ = jax_run
    port = port_from_jax(key, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(clips())).numpy()
    assert got.shape == (1, OUT) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_serving_matches_jax_bf16_serving(jax_run):
    key, variables, f32, want = jax_run
    server = VideoServer(key, port_from_jax(key, variables), device="cpu")
    assert server.dtype == torch.bfloat16 and server.batch == 2
    got = server(clips()).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= BF16_SHARE * np.abs(f32).max()


def test_backbone_converts_back_to_the_jax_tree(jax_run):
    key, variables, _, _ = jax_run
    port = port_from_jax(key, variables)
    params, stats = convert_mvit(port.backbone.state_dict(), OUT,
                                 VARIANTS[key])
    want = dict(variables["params"])
    # convert_mvit draws a fresh task head; the backbone must come back
    params.pop("head"), want.pop("head")
    assert stats == {}
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(want))
    for got, ref in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_torchvision_keyed_reference_loads_strictly(key):
    ref = MViTRef(VARIANTS[key], num_classes=400, spatial_size=CLIP[1:],
                  temporal_size=CLIP[0])
    port = build_video_model(key, OUT, CLIP)
    port.backbone.load_state_dict(ref.state_dict(), strict=True)
    for name, value in ref.state_dict().items():
        assert torch.equal(port.backbone.state_dict()[name], value), name


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_resize_mvit_tables_matches_tools(key):
    variant = VARIANTS[key]
    state = build_video_model(key, OUT, CLIP, seed=3).backbone.state_dict()
    target = (16, 96, 128)
    got, _ = convert_mvit(resize_mvit_tables(state, variant, target), OUT,
                          variant)
    want, _ = convert_mvit(state, OUT, variant)
    want = tools_resize(want, variant, target)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
    # the resized tables are the target clip's
    model = build_video_model(key, OUT, target)
    model.backbone.load_state_dict(
        resize_mvit_tables(state, variant, target), strict=True)


@pytest.mark.parametrize("pool_q", [False, True])
def test_attention_below_the_gate_matches_jax(pool_q):
    """One v2 MultiscaleAttention at 33 queries (the eager einsum path with
    the relative bias), first-block-of-a-stage settings when pool_q."""
    thw = (2, 4, 4)
    out_dim, heads = (192, 2) if pool_q else (96, 1)
    settings = dict(embed_dim=96, output_dim=out_dim, num_heads=heads,
                    q_stride=(1, 2, 2) if pool_q else (1, 1, 1),
                    kv_stride=(1, 2, 2), has_pool_q=pool_q,
                    residual_pool=True, residual_with_cls=False, rel_pos=True)
    jattn = jax_mvit.MultiscaleAttention(**settings)
    x = np.random.default_rng(5).standard_normal((2, 33, 96)).astype(
        np.float32)
    variables = jattn.init(jax.random.PRNGKey(2), jnp.asarray(x), thw)
    want, want_thw = jattn.apply(variables, jnp.asarray(x), thw)

    attn = mvit.MultiscaleAttention(
        **settings, input_thw=thw,
        generator=torch.Generator().manual_seed(0)).eval()
    sd = {}
    weights._mvit_attention(sd, jax.tree_util.tree_map(
        np.asarray, variables["params"]), "a")
    attn.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got, got_thw = attn(torch.from_numpy(x), thw)
    assert got_thw == tuple(want_thw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
