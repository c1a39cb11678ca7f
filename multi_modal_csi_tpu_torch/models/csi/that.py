"""THAT (Two-stream Transformer for Human Activity recognition) and its head
variants, for serving and training. Counterpart of the JAX package's
``models/csi/that.py``; parameter names follow the reference torch layout
(``layer_left_encoder.0.layer_attention.in_proj_weight`` ...).

The left stream attends over the 150 pooled time steps with the 270
channels as features (10 heads of 27); the right stream attends over the
270 channels with the 150 pooled time steps as features (10 heads of 15).
Both sequences pass the attention's flash gate, so every THAT forward runs
the fused attention kernel five times, and every training step its
backward five times too. Dropout sits where the JAX package has it
(``that.py:77, 86, 90, 117, 128`` there): 0.1 after each attention, inside
each conv branch and after the branch average; 0.5 on each stream's
feature. It is the identity in eval mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...nn.init import xavier_uniform_
from ...nn.layers import (BatchNorm, Conv1d, Dropout, LayerNorm, Linear,
                          MultiheadAttention, avg_pool1d, leaky_relu)


class GaussianPosition(nn.Module):
    """Learned mixture-of-Gaussians positional encoding: a softmax over
    ``num_gaussian`` learned (mu, sigma) pdfs at each position mixes a
    learned embedding table."""

    def __init__(self, dim_feature: int, dim_time: int,
                 num_gaussian: int = 10, *, generator: torch.Generator):
        super().__init__()
        k, t = num_gaussian, dim_time
        self.var_embedding = nn.Parameter(torch.empty(k, dim_feature))
        xavier_uniform_(self.var_embedding, generator)
        self.var_mu = nn.Parameter(
            torch.arange(0.0, t, t / k, dtype=torch.float32)[None, :k])
        self.var_sigma = nn.Parameter(torch.full((1, k), 50.0))
        self.register_buffer(
            "var_position", torch.arange(t, dtype=torch.float32)[:, None],
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sigma = self.var_sigma
        d = self.var_position - self.var_mu                        # (T, K)
        pdf = -d * d / (2.0 * sigma * sigma) - torch.log(sigma)
        weights = torch.softmax(pdf, dim=-1)
        pos_enc = weights @ self.var_embedding.float()             # (T, F)
        return x + pos_enc[None]


class EncoderBlock(nn.Module):
    """Pre-LN attention, dropout, residual; then a LayerNorm'd bank of
    Conv1d + BatchNorm + dropout + LeakyReLU branches ("SAME" padding, one
    per kernel size), averaged, dropout, residual."""

    def __init__(self, dim_feature: int, num_heads: int = 10,
                 conv_sizes: Sequence[int] = (1, 3, 5), *,
                 generator: torch.Generator):
        super().__init__()
        self.layer_norm_0 = LayerNorm(dim_feature)
        self.layer_attention = MultiheadAttention(dim_feature, num_heads,
                                                  generator=generator)
        self.layer_dropout_0 = Dropout(0.1)
        self.layer_norm_1 = LayerNorm(dim_feature)
        # Sequential(conv, bn, dropout): parameters named layer_cnn.{i}.0
        # and .1, as in the reference
        self.layer_cnn = nn.ModuleList(
            nn.Sequential(Conv1d(dim_feature, dim_feature, size,
                                 padding="SAME", xavier=False,
                                 generator=generator),
                          BatchNorm(dim_feature), Dropout(0.1))
            for size in conv_sizes)
        self.layer_dropout_1 = Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.layer_norm_0(x)
        t = self.layer_dropout_0(self.layer_attention(t, t, t)) + x
        s = self.layer_norm_1(t)
        branches = [leaky_relu(branch(s)) for branch in self.layer_cnn]
        return self.layer_dropout_1(sum(branches) / len(branches)) + t


class THATTrunk(nn.Module):
    """The two-stream trunk: (B, length, channels) windows to a 288-wide
    feature (256 left + 32 right). The head variants subclass it, so their
    parameters keep the reference's flat names."""

    def __init__(self, *, length: int = 3000, channels: int = 270,
                 pool: int = 20, generator: torch.Generator):
        super().__init__()
        g = generator
        dim_right = length // pool
        self.pool = pool
        self.layer_left_gaussian = GaussianPosition(channels, dim_right,
                                                    generator=g)
        self.layer_left_encoder = nn.ModuleList(
            EncoderBlock(channels, 10, (1, 3, 5), generator=g)
            for _ in range(4))
        self.layer_left_norm = LayerNorm(channels)
        self.layer_left_cnn_0 = Conv1d(channels, 128, 8, xavier=False,
                                       generator=g)
        self.layer_left_cnn_1 = Conv1d(channels, 128, 16, xavier=False,
                                       generator=g)
        self.layer_right_encoder = nn.ModuleList(
            [EncoderBlock(dim_right, 10, (1, 2, 3), generator=g)])
        self.layer_right_norm = LayerNorm(dim_right)
        self.layer_right_cnn_0 = Conv1d(dim_right, 16, 2, xavier=False,
                                        generator=g)
        self.layer_right_cnn_1 = Conv1d(dim_right, 16, 4, xavier=False,
                                        generator=g)
        self.layer_left_dropout = Dropout(0.5)
        self.layer_right_dropout = Dropout(0.5)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        pooled = avg_pool1d(x, self.pool)                     # (B, 150, 270)

        left = self.layer_left_gaussian(pooled)
        for block in self.layer_left_encoder:
            left = block(left)
        left = self.layer_left_norm(left)
        left = torch.cat([leaky_relu(self.layer_left_cnn_0(left)).sum(dim=1),
                          leaky_relu(self.layer_left_cnn_1(left)).sum(dim=1)],
                         dim=-1)                              # (B, 256)
        left = self.layer_left_dropout(left)

        right = pooled.transpose(1, 2)                        # (B, 270, 150)
        for block in self.layer_right_encoder:
            right = block(right)
        right = self.layer_right_norm(right)
        right = torch.cat(
            [leaky_relu(self.layer_right_cnn_0(right)).sum(dim=1),
             leaky_relu(self.layer_right_cnn_1(right)).sum(dim=1)],
            dim=-1)                                           # (B, 32)
        right = self.layer_right_dropout(right)

        dtype = torch.promote_types(left.dtype, right.dtype)
        return torch.cat([left.to(dtype), right.to(dtype)], dim=-1)


FEATURES = 288


class THAT(THATTrunk):
    """Single-head THAT: (B, out_features) logits."""

    def __init__(self, out_features: int, *, generator: torch.Generator,
                 **trunk):
        super().__init__(generator=generator, **trunk)
        self.layer_output = Linear(FEATURES, out_features, xavier=False,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_output(self.features(x))


class THATMultiHead(THATTrunk):
    """THAT with parallel per-user heads: (B, num_heads, out_features)."""

    def __init__(self, out_features: int, num_heads: int = 5, *,
                 generator: torch.Generator, **trunk):
        super().__init__(generator=generator, **trunk)
        self.layer_output = nn.ModuleList(
            Linear(FEATURES, out_features, xavier=False, generator=generator)
            for _ in range(num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = self.features(x)
        return torch.stack([head(t) for head in self.layer_output], dim=1)


class THATCount(THAT):
    """THAT with one count-regression head: (B, 9)."""

    def __init__(self, out_features: int = 9, *,
                 generator: torch.Generator, **trunk):
        super().__init__(out_features, generator=generator, **trunk)


class THATCountConstrained(THATTrunk):
    """THAT -> Linear(288 -> persons x classes) -> softmax per person ->
    expected counts summed over persons, (B, classes); they sum to
    ``num_persons`` by construction."""

    def __init__(self, num_persons: int = 5, num_classes: int = 10, *,
                 generator: torch.Generator, **trunk):
        super().__init__(generator=generator, **trunk)
        self.num_persons, self.num_classes = num_persons, num_classes
        self.layer_output = Linear(FEATURES, num_persons * num_classes,
                                   xavier=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.layer_output(self.features(x))
        logits = logits.reshape(-1, self.num_persons, self.num_classes)
        return torch.softmax(logits, dim=2).sum(dim=1)
