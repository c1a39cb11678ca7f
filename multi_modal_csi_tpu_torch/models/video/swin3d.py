"""Video Swin Transformer (torchvision's ``swin3d_t`` and ``swin3d_s``): the
port of the JAX package's ``models/video/swin3d.py``.

- the patch embed: the clip zero-padded to a multiple of the (2, 4, 4)
  patch, a conv patchify to ``embed_dim``, LayerNorm;
- four stages of Swin blocks: 3-D window attention (window (8, 7, 7),
  clipped to the stage's size) with a learned relative position bias,
  every second block shifted by half a window (a cyclic roll and the -100
  region mask); pre-LayerNorm residuals, an MLP of ratio 4 with flax's
  tanh GELU, stochastic depth at rates from ``np.linspace(0, 0.1, n)``;
- PatchMerging between stages (2 x 2 spatial neighbours concatenated in
  torchvision's order, LayerNorm, Linear to 2C without bias);
- a final LayerNorm, the global mean, ``head`` to 400, the task head.

The attention is eager PyTorch, with the logits, the bias, the mask, the
softmax and P.V in f32, as JAX's own plain-XLA path (no Pallas kernel:
the JAX package measured one and deleted it). The bias table is sized to
the full configured window and the pair index cut to the clipped token
count (``[:n, :n]``), torchvision's scheme, copied exactly. Every
LayerNorm has eps 1e-5.

The input is the JAX cache layout (B, T, H, W, 3); activations stay
channels-last. ``Swin3DBackbone`` carries torchvision's parameter names
(``patch_embed.proj``, ``features.{2s}.{block}.attn.qkv``,
``features.{2s + 1}.reduction``, ``norm``, ``head``), so a torchvision
state dict loads into ``Swin3D.backbone`` (its ``relative_position_index``
buffers dropped: the port computes the index); the task head (400 -> out)
is ``Swin3D.task_head``.

Known difference from torchvision: the MLP uses flax's tanh GELU, as the
JAX package does, so a torchvision checkpoint gives slightly different
logits than torchvision does.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import GELU, Conv3d, DropPath, LayerNorm, Linear

Window = Tuple[int, int, int]

PATCH: Window = (2, 4, 4)
WINDOW: Window = (8, 7, 7)
EMBED_DIM = 96
NUM_HEADS = (3, 6, 12, 24)
MLP_RATIO = 4
DROP_PATH_RATE = 0.1
LN_EPS = 1e-5
TABLE_STD = 0.02                 # truncated at two standard deviations
MASK = -100.0                    # the shifted layout's cross-region logit
BACKBONE_CLASSES = 400


def _pad_to_multiple(x: torch.Tensor, window: Window) -> torch.Tensor:
    """(B, T, H, W, C) zero-padded at the end of T, H and W to multiples
    of ``window``."""
    pt, ph, pw = ((-s) % w for s, w in zip(x.shape[1:4], window))
    if pt or ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph, 0, pt))
    return x


def window_partition(x: torch.Tensor, window: Window) -> torch.Tensor:
    """(B, T, H, W, C) -> (B nW, wt wh ww, C)."""
    b, t, h, w, c = x.shape
    wt, wh, ww = window
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wt * wh * ww, c)


def window_reverse(windows: torch.Tensor, window: Window, b: int, t: int,
                   h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    wt, wh, ww = window
    c = windows.shape[-1]
    x = windows.reshape(b, t // wt, h // wh, w // ww, wt, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, w, c)


@functools.lru_cache(maxsize=None)
def _relative_position_index(window: Window) -> np.ndarray:
    """(N, N) flat index into the bias table for every token pair of a
    full window."""
    coords = np.stack(np.meshgrid(*[np.arange(s) for s in window],
                                  indexing="ij"))          # (3, wt, wh, ww)
    flat = coords.reshape(3, -1)                           # (3, N)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += window[0] - 1
    rel[..., 1] += window[1] - 1
    rel[..., 2] += window[2] - 1
    rel[..., 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[..., 1] *= 2 * window[2] - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _shift_window_ids(dims: Window, window: Window,
                      shift: Window) -> np.ndarray:
    """(nW, N) int32 region ids of each window's tokens in the shifted
    layout of a (T, H, W) volume; two tokens attend freely where their ids
    agree, and with ``MASK`` added to their logit where they do not."""
    t, h, w = dims
    img = np.zeros((1, t, h, w, 1))
    slices = [[slice(0, -win), slice(-win, -sh), slice(-sh, None)]
              if sh else [slice(None)]
              for win, sh in zip(window, shift)]
    for cnt, (st, sh_, sw) in enumerate(itertools.product(*slices)):
        img[:, st, sh_, sw, :] = cnt
    wt, wh, ww = window
    ids = img.reshape(1, t // wt, wt, h // wh, wh, w // ww, ww, 1)
    ids = ids.transpose(0, 1, 3, 5, 2, 4, 6, 7)
    return ids.reshape(-1, wt * wh * ww).astype(np.int32)


class WindowAttention3D(nn.Module):
    """Multi-head self-attention within each window, with the relative
    position bias of the full ``window`` (the table's size) cut to the
    windows' token count, and the shifted layout's mask where ``ids`` are
    given. Names: ``qkv``, ``proj``, ``relative_position_bias_table``."""

    def __init__(self, dim: int, num_heads: int, window: Window, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads, self.window = num_heads, tuple(window)
        self.qkv = Linear(dim, 3 * dim, xavier=False, generator=generator)
        self.proj = Linear(dim, dim, xavier=False, generator=generator)
        size = math.prod(2 * w - 1 for w in window)
        table = torch.empty(size, num_heads)
        nn.init.trunc_normal_(table, std=TABLE_STD, a=-2 * TABLE_STD,
                              b=2 * TABLE_STD, generator=generator)
        self.relative_position_bias_table = nn.Parameter(table)

    def forward(self, x: torch.Tensor,
                ids: Optional[torch.Tensor]) -> torch.Tensor:
        bn, n, c = x.shape
        h = self.num_heads
        d = c // h
        qkv = self.qkv(x).reshape(bn, n, 3, h, d).permute(2, 0, 3, 1, 4)
        acc = torch.promote_types(qkv.dtype, torch.float32)   # f32 or f64
        q, k, v = qkv[0].to(acc), qkv[1].to(acc), qkv[2].to(acc)
        attn = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        idx = torch.from_numpy(_relative_position_index(self.window)
                               [:n, :n].reshape(-1)).to(x.device)
        bias = self.relative_position_bias_table[idx]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if ids is not None:
            nw = ids.shape[0]
            mask = torch.where(ids[:, None, :] == ids[:, :, None], 0.0, MASK)
            attn = (attn.reshape(bn // nw, nw, h, n, n)
                    + mask[None, :, None]).reshape(bn, h, n, n)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(bn, n, c))


class SwinBlock3D(nn.Module):
    """One Swin block: (shifted) window attention and the MLP, each a
    pre-LayerNorm residual with stochastic depth. Names: ``norm1``,
    ``attn``, ``norm2``, ``mlp.0``, ``mlp.3``."""

    def __init__(self, dim: int, num_heads: int, window: Window,
                 shifted: bool, drop_path: float, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.window, self.shifted = tuple(window), shifted
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, num_heads, window, generator=g)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        hidden = int(dim * MLP_RATIO)
        self.mlp = nn.Sequential(
            Linear(dim, hidden, xavier=False, generator=g), GELU(),
            nn.Identity(), Linear(hidden, dim, xavier=False, generator=g))
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = x.shape
        window = tuple(min(ws, s) for ws, s in zip(self.window, (t, h, w)))
        shift = tuple(ws // 2 if self.shifted and ws < s else 0
                      for ws, s in zip(window, (t, h, w)))
        shortcut = x
        x = _pad_to_multiple(self.norm1(x), window)
        _, tp, hp, wp, _ = x.shape
        ids = None
        if any(shift):
            x = torch.roll(x, tuple(-s for s in shift), dims=(1, 2, 3))
            ids = torch.from_numpy(_shift_window_ids(
                (tp, hp, wp), window, shift)).to(x.device)
        x = window_reverse(self.attn(window_partition(x, window), ids),
                           window, b, tp, hp, wp)
        if any(shift):
            x = torch.roll(x, shift, dims=(1, 2, 3))
        x = shortcut + self.drop_path(x[:, :t, :h, :w])
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging3D(nn.Module):
    """2 x 2 spatial merge: (H, W) zero-padded to even, the neighbours at
    (h, w) offsets (0, 0), (1, 0), (0, 1), (1, 1) concatenated on channels
    (torchvision's order), LayerNorm, Linear(4C -> 2C) without bias."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        parts = [x[:, :, i::2, j::2] for j in (0, 1) for i in (0, 1)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class PatchEmbed3D(nn.Module):
    """The clip zero-padded to a multiple of the patch, the conv patchify
    (``proj``, a plain unhooked Conv3d as JAX's raw ``nn.Conv``) and
    LayerNorm (``norm``)."""

    def __init__(self, embed_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.proj = Conv3d(3, embed_dim, PATCH, stride=PATCH,
                           generator=generator)
        self.norm = LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(_pad_to_multiple(x, PATCH)))


class Swin3DBackbone(nn.Module):
    """The backbone up to torchvision's 400-way ``head``, with
    torchvision's parameter names. Input (B, T, H, W, 3); output (B, 400).
    ``clip`` is the (T, H, W) it serves (the layers take any)."""

    def __init__(self, clip: Window, *, embed_dim: int = EMBED_DIM,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = NUM_HEADS,
                 window: Window = WINDOW, generator: torch.Generator):
        super().__init__()
        g = generator
        self.clip = tuple(clip)
        self.patch_embed = PatchEmbed3D(embed_dim, generator=g)
        rates = np.linspace(0, DROP_PATH_RATE, sum(depths))
        layers, dim, k = [], embed_dim, 0
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = []
            for blk in range(depth):
                blocks.append(SwinBlock3D(dim, heads, window, blk % 2 == 1,
                                          float(rates[k]), generator=g))
                k += 1
            layers.append(nn.Sequential(*blocks))
            if stage < len(depths) - 1:
                layers.append(PatchMerging3D(dim, generator=g))
                dim *= 2
        self.features = nn.Sequential(*layers)
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.head = Linear(dim, BACKBONE_CLASSES, xavier=False, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.features(self.patch_embed(x)))
        return self.head(x.mean(dim=(1, 2, 3)))


class Swin3D(nn.Module):
    """Swin3D backbone + task head (Linear(400 -> out_features),
    ``task_head``). ``embed_dim``, ``depths``, ``num_heads`` and
    ``window`` narrow it; Swin3D-T is depths (2, 2, 6, 2), Swin3D-S
    (2, 2, 18, 2)."""

    def __init__(self, out_features: int, clip: Window, *,
                 embed_dim: int = EMBED_DIM,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = NUM_HEADS,
                 window: Window = WINDOW, generator: torch.Generator):
        super().__init__()
        self.backbone = Swin3DBackbone(clip, embed_dim=embed_dim,
                                       depths=depths, num_heads=num_heads,
                                       window=window, generator=generator)
        self.task_head = Linear(BACKBONE_CLASSES, out_features, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.task_head(self.backbone(x))


def swin3d_t(out_features: int, clip: Window, *,
             generator: torch.Generator) -> Swin3D:
    return Swin3D(out_features, clip, depths=(2, 2, 6, 2),
                  generator=generator)


def swin3d_s(out_features: int, clip: Window, *,
             generator: torch.Generator) -> Swin3D:
    return Swin3D(out_features, clip, depths=(2, 2, 18, 2),
                  generator=generator)
