"""MViT, the Multiscale Vision Transformer for video (v1 and v2): the port of
the JAX package's ``models/video/mvit.py``.

torchvision's ``mvit_v1_b`` / ``mvit_v2_s`` module graph, as the JAX package
builds it:

- a conv patchify (3, 7, 7) / (2, 4, 4) / pad (1, 3, 3), then a class token;
- v1: an absolute positional encoding split into spatial, temporal and
  class tables; v2: decomposed relative position tables over t, h and w in
  every block;
- 16 pooling-attention blocks in 4 stages (1, 2, 11, 2): packed QKV,
  per-head depthwise-conv pooling (kernel 3, LayerNorm after) of Q at
  stage transitions and of K and V everywhere (stride 8/4/2/1 per stage),
  max pooling on the residual path, width 96 -> 192 -> 384 -> 768, head
  dim 96 everywhere;
- v1 widens in the MLP of a stage's last block, v2 in the attention of a
  stage's first block and adds Q back (class token left out);
- a final LayerNorm, the class token, Dropout(0.5) and Linear(400), then
  the task head.

The input is the JAX cache layout (B, T, H, W, 3); activations stay
channels-last. ``MViTBackbone`` carries torchvision's parameter names, so a
torchvision (or ``tools/torch_video_refs.py::MViTRef``) state dict loads
into ``MViT.backbone`` with ``strict=True``; the task head (400 -> out) is
``MViT.task_head``.

The tables are sized from the clip (T, H, W) given at construction, as JAX
sizes them from the traced input: v1's spatial and temporal tables match
the patchified clip; v2's relative tables follow each block's input size
and are interpolated at run time when the sizes differ.

Attention (``MultiscaleAttention``) mirrors the JAX gate
(``mvit.py:256-269`` there), with v2's relative bias passed as the
low-rank factor pair from ``_rel_factors`` (a zero class-token row in R
and column in S):

- in eval mode, with at least 256 queries, K3
  (``kernels/flash_attention_lowrank.py::flash_attention_lowrank_bias``;
  its plain version on CPU tensors);
- in training, on the card with at least 8192 queries (MViT's blocks 0-2
  at the serving clip), ``flash_attention_lowrank_bias_trainable``: K3
  forward, the flash backward K4;
- everywhere else the eager einsum path with ``_add_rel_pos``, in training
  on the CPU too, as the JAX package trains there.

Known difference from torchvision: the MLP uses flax's default GELU, the
tanh approximation (``nn.layers.GELU``), as the JAX package does.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.flash_attention_lowrank import (
    flash_attention_lowrank_bias, flash_attention_lowrank_bias_trainable)
from ...nn.layers import (GELU, Conv3d, Dropout, DropPath, LayerNorm, Linear,
                          max_pool3d)

THW = Tuple[int, int, int]

FLASH_MIN_QUERIES = 256          # eval gate of K3 (JAX mvit.py:257)
TRAIN_FLASH_MIN_QUERIES = 8192   # training gate of K4 (JAX mvit.py:259)
TABLE_STD = 0.02                 # truncated at two standard deviations
EMBED_DIM = 96
BACKBONE_CLASSES = 400           # torchvision's Kinetics-400 head
DROPOUT = 0.5                    # before that head
DROP_PATH_RATE = 0.2             # the last block's; 0 at the first


class BlockCfg(NamedTuple):
    in_ch: int
    out_ch: int
    heads: int
    q_stride: THW
    kv_stride: THW
    has_pool_q: bool


def _block_configs(variant: str) -> List[BlockCfg]:
    """torchvision mvit_v1_b / mvit_v2_s block settings (16 blocks)."""
    stages = (1, 2, 11, 2)
    stage_heads = (1, 2, 4, 8)
    stage_kv = ((1, 8, 8), (1, 4, 4), (1, 2, 2), (1, 1, 1))
    cfgs = []
    cur = EMBED_DIM
    for s, (n, heads) in enumerate(zip(stages, stage_heads)):
        for b in range(n):
            first = b == 0 and s > 0
            last = b == n - 1 and s < len(stages) - 1
            in_ch = cur
            if variant == "v1":
                out_ch = cur * 2 if last else cur      # widen in MLP
            else:
                out_ch = cur * 2 if first else cur     # widen in attention
            cur = out_ch
            cfgs.append(BlockCfg(in_ch, out_ch, heads,
                                 (1, 2, 2) if first else (1, 1, 1),
                                 stage_kv[s], has_pool_q=first))
    return cfgs


def patchified(clip: THW) -> THW:
    """(T, H, W) of the conv patchify's output for a clip (T, H, W)."""
    t, h, w = clip
    return (t - 1) // 2 + 1, (h - 1) // 4 + 1, (w - 1) // 4 + 1


def _pooled(thw: THW, stride: THW) -> THW:
    """Output size of a kernel-3, pad-1 pooling conv with ``stride``."""
    return tuple((n - 1) // s + 1 for n, s in zip(thw, stride))


def rel_table_sizes(input_thw: THW, q_stride: THW,
                    kv_stride: THW) -> Tuple[int, int]:
    """(spatial, temporal) lengths of a v2 block's relative tables for
    its input size ``input_thw``."""
    size = max(input_thw[1], input_thw[2])
    return (2 * max(size // q_stride[1], size // kv_stride[1]) - 1,
            2 * input_thw[0] - 1)


def _interp_weights(src: int, dst: int):
    """torch F.interpolate(mode='linear', align_corners=False) gather plan."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    pos = np.clip(pos, 0, src - 1)
    i0 = np.floor(pos).astype(np.int64)
    i1 = np.minimum(i0 + 1, src - 1)
    frac = (pos - i0).astype(np.float32)
    return i0, i1, frac


def interpolate_table(table: torch.Tensor, dst: int) -> torch.Tensor:
    """Linearly resize a (L, C) table along dim 0 (torchvision semantics).
    The f32 weights promote a bf16 table to f32, as in JAX."""
    src = table.shape[0]
    if src == dst:
        return table
    i0, i1, frac = (torch.from_numpy(a).to(table.device)
                    for a in _interp_weights(src, dst))
    frac = frac[:, None]
    return table[i0] * (1.0 - frac) + table[i1] * frac


def _rel_distances(q_size: int, k_size: int,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """torchvision _add_rel_pos distance indices, (q_size, k_size) int64,
    computed in f64 on ``device`` as numpy computes them in JAX."""
    q_ratio = max(k_size / q_size, 1.0)
    k_ratio = max(q_size / k_size, 1.0)
    qa = torch.arange(q_size, dtype=torch.float64, device=device)
    ka = torch.arange(k_size, dtype=torch.float64, device=device)
    dist = qa[:, None] * q_ratio - ka[None, :] * k_ratio + (k_size - 1) * k_ratio
    return dist.long()       # truncation, non-negative


def _rel_scatter_matrix(k_t: int, k_h: int, k_w: int,
                        device: Optional[torch.device] = None
                        ) -> torch.Tensor:
    """(k_t + k_h + k_w, K) f32 0/1 selector: row j scatters the j-th
    decomposed rel component over every key position that shares that
    t/h/w index."""
    kk = k_t * k_h * k_w
    s = torch.zeros((k_t + k_h + k_w, kk), dtype=torch.float32, device=device)
    kar = torch.arange(kk, device=device)
    s[kar // (k_h * k_w), kar] = 1.0                       # t component
    s[k_t + (kar // k_w) % k_h, kar] = 1.0                 # h component
    s[k_t + k_h + kar % k_w, kar] = 1.0                    # w component
    return s


def _rel_einsum(r_q: torch.Tensor, table: torch.Tensor,
                eq: str) -> torch.Tensor:
    dtype = torch.promote_types(r_q.dtype, table.dtype)
    return torch.einsum(eq, r_q.to(dtype), table.to(dtype))


def _rel_factors(q: torch.Tensor, q_thw: THW, k_thw: THW,
                 rel_h: torch.Tensor, rel_w: torch.Tensor,
                 rel_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-rank factors of the decomposed rel-pos bias:
    bias[:, :, 1:, 1:] == r_cat @ scatter, with r_cat (B, H, qq, m) in the
    promoted dtype of q and the tables (q's dtype in bf16 serving) and the
    static 0/1 selector scatter (m, K) in f32, m = k_t + k_h + k_w."""
    q_t, q_h, q_w = q_thw
    k_t, k_h, k_w = k_thw
    dev = q.device
    rh = interpolate_table(rel_h, 2 * max(q_h, k_h) - 1)[
        _rel_distances(q_h, k_h, dev)]                     # (q_h, k_h, d)
    rw = interpolate_table(rel_w, 2 * max(q_w, k_w) - 1)[
        _rel_distances(q_w, k_w, dev)]
    rt = interpolate_table(rel_t, 2 * max(q_t, k_t) - 1)[
        _rel_distances(q_t, k_t, dev)]
    b, heads, _, d = q.shape
    r_q = q[:, :, 1:].reshape(b, heads, q_t, q_h, q_w, d)
    rel_h_q = _rel_einsum(r_q, rh, "bythwc,hkc->bythwk")
    rel_w_q = _rel_einsum(r_q, rw, "bythwc,wkc->bythwk")
    rel_t_q = _rel_einsum(r_q, rt, "bythwc,tkc->bythwk")
    qq = q_t * q_h * q_w
    r_cat = torch.cat([rel_t_q.reshape(b, heads, qq, k_t),
                       rel_h_q.reshape(b, heads, qq, k_h),
                       rel_w_q.reshape(b, heads, qq, k_w)], dim=-1)
    return r_cat, _rel_scatter_matrix(k_t, k_h, k_w, dev)


def _add_rel_pos(attn: torch.Tensor, q: torch.Tensor, q_thw: THW,
                 k_thw: THW, rel_h: torch.Tensor, rel_w: torch.Tensor,
                 rel_t: torch.Tensor) -> torch.Tensor:
    """Decomposed relative position bias added to the f32 logits
    attn[:, :, 1:, 1:] (class-token row and column excluded), as the
    one-hot-selector product r_cat @ scatter in f32."""
    r_cat, scatter = _rel_factors(q, q_thw, k_thw, rel_h, rel_w, rel_t)
    rel = torch.einsum("byqm,mk->byqk", r_cat.float(), scatter)
    attn[:, :, 1:, 1:] += rel
    return attn


def _table(shape, generator: torch.Generator) -> nn.Parameter:
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, std=TABLE_STD, a=-2 * TABLE_STD,
                          b=2 * TABLE_STD, generator=generator)
    return nn.Parameter(t)


class PoolConv(nn.Module):
    """torchvision's Pool with a depthwise conv: the class token is split
    off, the tokens conv-pooled per head, the token re-attached, then
    LayerNorm(head_dim). Names: ``pool`` (the conv), ``norm_act.0``."""

    def __init__(self, head_dim: int, kernel: THW, stride: THW, *,
                 generator: torch.Generator):
        super().__init__()
        self.pool = Conv3d(head_dim, head_dim, kernel, stride=stride,
                           padding=tuple(k // 2 for k in kernel),
                           groups=head_dim, bias=False, generator=generator)
        self.norm_act = nn.Sequential(LayerNorm(head_dim))

    def forward(self, x: torch.Tensor, thw: THW
                ) -> Tuple[torch.Tensor, THW]:
        # x: (B, heads, 1 + T*H*W, d)
        b, heads, _, d = x.shape
        cls, tok = x[:, :, :1], x[:, :, 1:]
        tok = self.pool(tok.reshape(b * heads, *thw, d))
        new_thw = tuple(tok.shape[1:4])
        x = torch.cat([cls, tok.reshape(b, heads, -1, d)], dim=2)
        return self.norm_act(x), new_thw


def use_train_flash(q: torch.Tensor) -> bool:
    """The training gate (JAX ``mvit.py:258-259``): the flash forward and
    backward for q (B, heads, Nq, d) on the card with Nq >= 8192; the eager
    path elsewhere, on the CPU whatever Nq."""
    return q.is_cuda and q.shape[2] >= TRAIN_FLASH_MIN_QUERIES


def _pool_skip(x: torch.Tensor, thw: THW, stride: THW) -> torch.Tensor:
    """torchvision pool_skip: MaxPool3d(kernel=s+1, stride=s, pad=k//2) on
    the residual path (no parameters, class token kept)."""
    b, _, c = x.shape
    cls, tok = x[:, :1], x[:, 1:]
    kernel = tuple(s + 1 if s > 1 else s for s in stride)
    tok = max_pool3d(tok.reshape(b, *thw, c), kernel, stride,
                     tuple(k // 2 for k in kernel))
    return torch.cat([cls, tok.reshape(b, -1, c)], dim=1)


class MultiscaleAttention(nn.Module):
    """Pooling attention. ``input_thw`` is the block's input size at the
    clip the model is built for; v2's relative tables are sized from it."""

    def __init__(self, embed_dim: int, output_dim: int, num_heads: int,
                 q_stride: THW, kv_stride: THW, has_pool_q: bool,
                 residual_pool: bool, residual_with_cls: bool, rel_pos: bool,
                 input_thw: THW, *, generator: torch.Generator):
        super().__init__()
        self.num_heads, self.output_dim = num_heads, output_dim
        self.residual_pool = residual_pool
        self.residual_with_cls = residual_with_cls
        d = output_dim // num_heads
        g = generator
        self.qkv = Linear(embed_dim, 3 * output_dim, xavier=False, generator=g)
        self.project = nn.Sequential(
            Linear(output_dim, output_dim, xavier=False, generator=g))
        # torchvision creates pool_k/pool_v whenever kernel_kv is set —
        # mvit_v1_b/mvit_v2_s set (3,3,3) on every block (stride 1 included)
        self.pool_q = (PoolConv(d, (3, 3, 3), q_stride, generator=g)
                       if has_pool_q else None)
        self.pool_k = PoolConv(d, (3, 3, 3), kv_stride, generator=g)
        self.pool_v = PoolConv(d, (3, 3, 3), kv_stride, generator=g)
        self.rel_pos_h = self.rel_pos_w = self.rel_pos_t = None
        if rel_pos:
            rel_sp, rel_t = rel_table_sizes(input_thw, q_stride, kv_stride)
            self.rel_pos_h = _table((rel_sp, d), g)
            self.rel_pos_w = _table((rel_sp, d), g)
            self.rel_pos_t = _table((rel_t, d), g)

    def forward(self, x: torch.Tensor, thw: THW
                ) -> Tuple[torch.Tensor, THW]:
        b, n, _ = x.shape
        heads = self.num_heads
        d = self.output_dim // heads
        qkv = self.qkv(x).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]            # (B, heads, N, d)
        k, k_thw = self.pool_k(k, thw)
        v, _ = self.pool_v(v, thw)
        q_thw = thw
        if self.pool_q is not None:
            q, q_thw = self.pool_q(q, thw)
        tables = (None if self.rel_pos_h is None else
                  (self.rel_pos_h, self.rel_pos_w, self.rel_pos_t))

        nq = q.shape[2]
        use_flash = (use_train_flash(q) if self.training
                     else nq >= FLASH_MIN_QUERIES)
        if use_flash:
            r = s = None
            if tables is not None:
                r_cat, scatter = _rel_factors(q, q_thw, k_thw, *tables)
                # class-token row/col carry zero bias
                r = F.pad(r_cat.float(), (0, 0, 1, 0))
                s = F.pad(scatter, (1, 0))
            fa = (flash_attention_lowrank_bias_trainable if self.training
                  else flash_attention_lowrank_bias)
            out = fa(q.contiguous(), k, v, r, s)
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm",
                                (q / math.sqrt(d)).float(), k.float())
            if tables is not None:
                attn = _add_rel_pos(attn, q, q_thw, k_thw, *tables)
            attn = torch.softmax(attn, dim=-1)
            out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float())
        if self.residual_pool:
            if self.residual_with_cls:
                out = out + q
            else:        # out of place: the flash path saved ``out``
                out = out + F.pad(q[:, :, 1:], (0, 0, 1, 0))
        out = out.transpose(1, 2).reshape(b, -1, self.output_dim)
        return self.project(out), q_thw


class MViTBlock(nn.Module):
    def __init__(self, cfg: BlockCfg, residual_pool: bool,
                 residual_with_cls: bool, rel_pos: bool,
                 proj_after_attn: bool, input_thw: THW, drop_path: float = 0.0,
                 *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.cfg, self.proj_after_attn = cfg, proj_after_attn
        attn_dim = cfg.out_ch if proj_after_attn else cfg.in_ch
        self.norm1 = LayerNorm(cfg.in_ch)
        self.attn = MultiscaleAttention(
            cfg.in_ch, attn_dim, cfg.heads, cfg.q_stride, cfg.kv_stride,
            cfg.has_pool_q, residual_pool, residual_with_cls, rel_pos,
            input_thw, generator=g)
        self.norm2 = LayerNorm(attn_dim)
        self.mlp = nn.Sequential(
            Linear(attn_dim, 4 * attn_dim, xavier=False, generator=g),
            GELU(), nn.Identity(),
            Linear(4 * attn_dim, cfg.out_ch, xavier=False, generator=g))
        self.project = (Linear(cfg.in_ch, cfg.out_ch, xavier=False,
                               generator=g)
                        if cfg.in_ch != cfg.out_ch else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, thw: THW
                ) -> Tuple[torch.Tensor, THW]:
        cfg = self.cfg
        x_norm1 = self.norm1(x)
        x_attn, new_thw = self.attn(x_norm1, thw)
        if self.project is not None and self.proj_after_attn:
            x = self.project(x_norm1)
        if cfg.has_pool_q:
            x = _pool_skip(x, thw, cfg.q_stride)
        x = x + self.drop_path(x_attn)
        x_norm2 = self.norm2(x)
        y = self.mlp(x_norm2)
        if self.project is not None and not self.proj_after_attn:
            x = self.project(x_norm2)
        return x + self.drop_path(y), new_thw


class PositionalEncoding(nn.Module):
    """The class token and, for v1, the absolute spatial, temporal and
    class tables sized for the patchified clip ``thw``."""

    def __init__(self, embed_dim: int, thw: THW, rel_pos: bool, *,
                 generator: torch.Generator):
        super().__init__()
        t, h, w = thw
        self.class_token = _table((embed_dim,), generator)
        self.spatial_pos = self.temporal_pos = self.class_pos = None
        if not rel_pos:
            self.spatial_pos = _table((h * w, embed_dim), generator)
            self.temporal_pos = _table((t, embed_dim), generator)
            self.class_pos = _table((embed_dim,), generator)

    def forward(self, x: torch.Tensor, thw: THW) -> torch.Tensor:
        b, _, c = x.shape
        x = torch.cat([self.class_token.expand(b, 1, c), x], dim=1)
        if self.spatial_pos is not None:
            t, h, w = thw
            if self.spatial_pos.shape[0] != h * w or \
                    self.temporal_pos.shape[0] != t:
                raise ValueError(
                    f"MViT-v1's positional tables are sized for "
                    f"{self.temporal_pos.shape[0]} x "
                    f"{self.spatial_pos.shape[0]} patches, the clip gives "
                    f"{t} x {h * w}: build the model for this clip")
            pos = (self.temporal_pos.repeat_interleave(h * w, dim=0)
                   + self.spatial_pos.repeat(t, 1))
            x = x + torch.cat([self.class_pos[None], pos], dim=0)[None]
        return x


class MViTBackbone(nn.Module):
    """The backbone up to torchvision's 400-way head, with torchvision's
    parameter names. Input (B, T, H, W, 3); output (B, 400)."""

    def __init__(self, variant: str, clip: THW, *,
                 generator: torch.Generator):
        super().__init__()
        if variant not in ("v1", "v2"):
            raise ValueError(f"MViT variant is v1 or v2, got {variant!r}")
        g = generator
        self.variant, self.clip = variant, tuple(clip)
        v2 = variant == "v2"
        self.conv_proj = Conv3d(3, EMBED_DIM, (3, 7, 7), stride=(2, 4, 4),
                                padding=(1, 3, 3), generator=g)
        thw = patchified(self.clip)
        self.pos_encoding = PositionalEncoding(EMBED_DIM, thw, rel_pos=v2,
                                               generator=g)
        cfgs = _block_configs(variant)
        rates = np.linspace(0, DROP_PATH_RATE, len(cfgs))
        self.blocks = nn.ModuleList()
        for cfg, rate in zip(cfgs, rates):
            self.blocks.append(MViTBlock(
                cfg, residual_pool=v2, residual_with_cls=False, rel_pos=v2,
                proj_after_attn=v2, input_thw=thw, drop_path=float(rate),
                generator=g))
            if cfg.has_pool_q:
                thw = _pooled(thw, cfg.q_stride)
        width = cfgs[-1].out_ch
        self.norm = LayerNorm(width)
        self.head = nn.Sequential(
            Dropout(DROPOUT),
            Linear(width, BACKBONE_CLASSES, xavier=False, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_proj(x)
        b, t, h, w, c = x.shape
        thw = (t, h, w)
        x = self.pos_encoding(x.reshape(b, -1, c), thw)
        for block in self.blocks:
            x, thw = block(x, thw)
        return self.head(self.norm(x)[:, 0])


class MViT(nn.Module):
    """Multiscale ViT backbone + task head (Linear(400 -> out_features),
    ``task_head``). Built for clips of ``clip`` = (T, H, W) frames."""

    def __init__(self, out_features: int, variant: str, clip: THW, *,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = MViTBackbone(variant, clip, generator=generator)
        self.task_head = Linear(BACKBONE_CLASSES, out_features, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.task_head(self.backbone(x))


def mvit_v1_b(out_features: int, clip: THW, *,
              generator: torch.Generator) -> MViT:
    return MViT(out_features, "v1", clip, generator=generator)


def mvit_v2_s(out_features: int, clip: THW, *,
              generator: torch.Generator) -> MViT:
    return MViT(out_features, "v2", clip, generator=generator)
