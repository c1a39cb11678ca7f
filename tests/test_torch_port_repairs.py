"""Repairs of the port's open faults, on the CPU.

- The attention gate and K1/K2's limits: ``forward_fits`` and
  ``backward_fits`` (kernels/flash_attention.py, per dtype) copy the
  launchers' limits and hold at their boundary; past it the attention
  takes its eager branch (the JAX package's K2 takes XLA's backward
  there), so no shape that JAX runs is refused on the card.
- K3's limits: ``lowrank_fits`` (kernels/flash_attention_lowrank.py, D
  and the bias's factor columns M up to 128 in both dtypes) holds at its
  boundary, and MViT's attention takes its eager branch past it.
- MViT tables at a clip whose pooled size is odd: ``resize_mvit_tables``
  sizes them as the live model does (the pooling convs give ceilings), so
  a torchvision-layout checkpoint loads into an MViT built at (8, 48, 48).
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch.core.weights import resize_mvit_tables
from multi_modal_csi_tpu_torch.kernels.flash_attention import (
    MAX_SHARED_BYTES, TC_MAX_HEAD_DIM, backward_fits, forward_fits)
from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
    MAX_BIAS_RANK, MAX_HEAD_DIM, lowrank_fits)
from multi_modal_csi_tpu_torch.models.video import mvit
from multi_modal_csi_tpu_torch.models.video.mvit import (_block_configs,
                                                         _pooled, patchified)
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.runners.video import (build_video_model,
                                                     load_video_pretrained)
from test_torch_port_layers import gen, run

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [15, 27, 45])
def test_fit_predicates_at_their_boundary(d, dtype):
    """The largest Nk (and Nq = Nk) that fits, and one more, against the
    launchers' formulas and the 232,448-byte limit. K1 in bf16 streams the
    keys (any Nk) and takes D <= 128; K2 has one kernel for both dtypes."""
    assert MAX_SHARED_BYTES == 232448
    n = max(n for n in range(1, 20000) if backward_fits(n, n, d))
    assert not backward_fits(n + 1, n + 1, d)
    if dtype == torch.bfloat16:
        assert all(forward_fits(nk, d, dtype) for nk in (1, 933, 934, 10**6))
        assert forward_fits(1, TC_MAX_HEAD_DIM, dtype)
        assert not forward_fits(1, TC_MAX_HEAD_DIM + 1, dtype)
        if d == 27:
            assert n == 457
        return
    nk = max(n for n in range(1, 20000) if forward_fits(n, d, dtype))
    assert not forward_fits(nk + 1, d, dtype)
    assert 4 * (nk * (d | 1) + nk * d + 8 * nk + 8 * d) <= MAX_SHARED_BYTES
    if d == 27:                 # THAT's heads: about 934 keys, 457 tokens
        assert (nk, n) == (933, 457)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backward_fits_head_dim(dtype):
    """K2's f32 instantiation (the tensor-core backward body) takes spans
    up to D = 128; its bf16 one, on the CUDA cores, any D whose operands
    fit. 64 tokens of D = 129 fit in shared memory, so only the span
    refuses them in f32 (the training gate then takes the eager
    branch)."""
    assert backward_fits(64, 64, TC_MAX_HEAD_DIM, dtype)
    assert backward_fits(64, 64, TC_MAX_HEAD_DIM + 1,
                         dtype) == (dtype == torch.bfloat16)
    assert 4 * (4 * 64 * (TC_MAX_HEAD_DIM + 1 | 1) + 3 * 64
                + 16 * 64) <= MAX_SHARED_BYTES


def _record(monkeypatch, name):
    calls = []
    real = getattr(P, name)
    monkeypatch.setattr(P, name, lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_attention_takes_eager_branch_past_the_boundary(training, dtype,
                                                        monkeypatch):
    """One head: the fused branch at the largest fitting shape, the eager
    branch one step beyond; both agree (f32 within 2e-5; bf16, where the
    eager branch rounds the logits to bf16, within BF16_TOL 2^-6 of
    chip_smoke.py). At D = 27 in f32 the step is a token (933 keys in
    eval, 457 in training); in bf16 eval K1 streams the keys, so 934 keys
    fuse and the step is the head dim (128 to 129); bf16 training keeps
    K2's 457."""
    d, last = 27, 933 if not training else 457
    if dtype == torch.bfloat16 and not training:
        d, last = TC_MAX_HEAD_DIM, 934
    name = "flash_attention_trainable" if training else "flash_attention"
    calls = _record(monkeypatch, name)

    def attend(d, n):
        mha = P.MultiheadAttention(d, 1, generator=gen()).train(training)
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, n, d), dtype=np.float32))
        return run(mha.to(dtype), *(x.to(dtype),) * 3)

    if dtype == torch.bfloat16 and not training:
        attend(27, last)
        assert len(calls) == 1         # past f32's 933 keys: fused
        calls.clear()
        attend(d, 64)
        attend(d + 1, 64)
        d, n_out = d + 1, 64
    else:
        attend(d, last)
        attend(d, last + 1)
        n_out = last + 1
    assert len(calls) == 1             # only the fitting one was fused
    eager = attend(d, n_out)
    calls.clear()
    with monkeypatch.context() as m:
        m.setattr(P, "forward_fits", lambda nk, d, dtype: True)
        m.setattr(P, "backward_fits", lambda nq, nk, d, dtype: True)
        fused = attend(d, n_out)
    assert len(calls) == 1
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    torch.testing.assert_close(eager.float(), fused.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("d", [8, 96, MAX_HEAD_DIM])
def test_lowrank_fits_at_its_boundary(d):
    """K3 takes M up to 128 factor columns (0: no bias) and D up to 128."""
    assert MAX_BIAS_RANK == 128
    assert lowrank_fits(d, 0) and lowrank_fits(d, MAX_BIAS_RANK)
    assert not lowrank_fits(d, MAX_BIAS_RANK + 1)
    assert not lowrank_fits(MAX_HEAD_DIM + 1, 37)


@pytest.mark.parametrize("grid", [(1, 63, 64), (1, 64, 64)],
                         ids=["M=128", "M=129"])
def test_mvit_attention_gate_at_the_bias_rank(grid, monkeypatch):
    """MViT-v2's attention in eval mode at a key grid whose bias has
    T + H + W = 128 factor columns calls K3; at 129 it takes the eager
    branch. Both agree with the eager branch forced (f32, within 2e-5)."""
    calls = []
    real = mvit.flash_attention_lowrank_bias
    monkeypatch.setattr(mvit, "flash_attention_lowrank_bias",
                        lambda *a: calls.append(1) or real(*a))
    attn = mvit.MultiscaleAttention(
        8, 8, 1, (1, 1, 1), (1, 1, 1), False, True, True, True, grid,
        generator=gen()).eval()
    n = 1 + grid[0] * grid[1] * grid[2]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, n, 8), dtype=np.float32))
    got, _ = run(attn, x, grid)
    assert len(calls) == (1 if sum(grid) <= MAX_BIAS_RANK else 0)
    monkeypatch.setattr(mvit, "lowrank_fits", lambda d, m: False)
    want, _ = run(attn, x, grid)
    assert len(calls) == (1 if sum(grid) <= MAX_BIAS_RANK else 0)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("key", ["MViT-v1", "MViT-v2"])
def test_pretrained_loads_at_an_odd_pooled_clip(key, tmp_path):
    """(8, 48, 48) patchifies to 12 x 12, pooled to 6, 3 and then 2 (a
    ceiling: the floor would give 1 and too short a last-stage table)."""
    clip = (8, 48, 48)
    thw = patchified(clip)
    for cfg in _block_configs("v2"):
        if cfg.has_pool_q:
            thw = _pooled(thw, cfg.q_stride)
    assert thw[1:] == (2, 2)
    source = build_video_model(key, 6, (16, 64, 64), seed=3)
    path = tmp_path / "mvit.pth"
    torch.save(source.backbone.state_dict(), path)
    model = load_video_pretrained(str(path), key,
                                  build_video_model(key, 6, clip, seed=0))
    live = build_video_model(key, 6, clip, seed=0).backbone.state_dict()
    got = model.backbone.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in live.items()}
    if key == "MViT-v2":
        resized = resize_mvit_tables(source.backbone.state_dict(), "v2",
                                     clip)
        assert torch.equal(got["blocks.15.attn.rel_pos_h"],
                           resized["blocks.15.attn.rel_pos_h"])
        assert got["blocks.15.attn.rel_pos_h"].shape[0] == 3
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, *clip, 3), dtype=np.float32))
    assert torch.isfinite(run(model.eval(), x)).all()
