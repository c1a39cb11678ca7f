"""Repairs of the port's open faults, on the CPU.

- The attention gate and K1/K2's shared memory: ``forward_fits`` and
  ``backward_fits`` (kernels/flash_attention.py) copy the launchers'
  ``smem_bytes`` and hold at their boundary; past it the attention takes
  its eager branch (the JAX package's K2 takes XLA's backward there), so
  no shape that JAX runs is refused on the card.
- MViT tables at a clip whose pooled size is odd: ``resize_mvit_tables``
  sizes them as the live model does (the pooling convs give ceilings), so
  a torchvision-layout checkpoint loads into an MViT built at (8, 48, 48).
"""

import numpy as np
import pytest
import torch

from multi_modal_csi_tpu_torch.core.weights import resize_mvit_tables
from multi_modal_csi_tpu_torch.kernels.flash_attention import (
    MAX_SHARED_BYTES, backward_fits, forward_fits)
from multi_modal_csi_tpu_torch.models.video.mvit import (_block_configs,
                                                         _pooled, patchified)
from multi_modal_csi_tpu_torch.nn import layers as P
from multi_modal_csi_tpu_torch.runners.video import (build_video_model,
                                                     load_video_pretrained)
from test_torch_port_layers import gen, run

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [15, 27, 45])
def test_fit_predicates_at_their_boundary(d):
    """The largest Nk (and Nq = Nk) that fits, and one more, against the
    launchers' formulas and the 232,448-byte limit."""
    assert MAX_SHARED_BYTES == 232448
    nk = max(n for n in range(1, 20000) if forward_fits(n, d))
    assert not forward_fits(nk + 1, d)
    assert 4 * (nk * (d | 1) + nk * d + 8 * nk + 8 * d) <= MAX_SHARED_BYTES
    n = max(n for n in range(1, 20000) if backward_fits(n, n, d))
    assert not backward_fits(n + 1, n + 1, d)
    if d == 27:                 # THAT's heads: about 934 keys, 457 tokens
        assert (nk, n) == (933, 457)


def _record(monkeypatch, name):
    calls = []
    real = getattr(P, name)
    monkeypatch.setattr(P, name, lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_attention_takes_eager_branch_past_the_boundary(training,
                                                        monkeypatch):
    """One head of D = 27: the fused branch at the largest fitting token
    count, the eager branch one token beyond; both agree."""
    d = 27
    last = 933 if not training else 457
    mha = P.MultiheadAttention(d, 1, generator=gen()).train(training)
    name = "flash_attention_trainable" if training else "flash_attention"
    calls = _record(monkeypatch, name)
    outs = []
    for n in (last, last + 1):
        x = torch.from_numpy(np.random.default_rng(4).standard_normal(
            (1, n, d), dtype=np.float32))
        outs.append(run(mha, x, x, x))
    assert len(calls) == 1             # only the fitting one was fused
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, last + 1, d), dtype=np.float32))
    calls.clear()
    with monkeypatch.context() as m:
        m.setattr(P, "forward_fits", lambda nk, d: True)
        m.setattr(P, "backward_fits", lambda nq, nk, d: True)
        fused = run(mha, x, x, x)
    assert len(calls) == 1
    torch.testing.assert_close(outs[1], fused, atol=2e-5, rtol=2e-5)


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
