"""DETR-style multi-user set prediction over CSI windows, for serving and
training. Counterpart of the JAX package's ``models/csi/detr.py``; parameter
names follow the reference torch layout
(``feature_extractor.dilated_blocks.2.bn.running_var``,
``decoder.decoder_layers.0.cross_attn.out_proj.weight`` ...).

Its attention runs over 10 memory tokens and 5 queries, below the flash
gate's 64, so DETR takes the attention's eager branch, as in JAX, in
serving and in training. Training mode uses batch statistics in the
feature extractor's BatchNorms and every dropout of the JAX package
(``detr.py:107-128`` there, and the encoder blocks').
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.layers import (BatchNorm, Conv1d, Dropout, LayerNorm, Linear,
                          MultiheadAttention, max_pool1d)
from .that import EncoderBlock, GaussianPosition


class DepthwiseSeparableConv(nn.Module):
    """Depthwise k-wide conv (groups = channels) + pointwise 1x1, no
    activation."""

    def __init__(self, channels: int, features: int, kernel_size: int,
                 padding: int, *, generator: torch.Generator):
        super().__init__()
        self.depthwise = Conv1d(channels, channels, kernel_size,
                                padding=padding, groups=channels,
                                xavier=False, generator=generator)
        self.pointwise = Conv1d(channels, features, 1, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class DilatedConvBlock(nn.Module):
    """k3 dilated conv + BatchNorm + ReLU."""

    def __init__(self, channels: int, dilation: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = Conv1d(channels, channels, 3, padding=dilation,
                           dilation=dilation, xavier=False,
                           generator=generator)
        self.bn = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class CNNFeatureExtractor(nn.Module):
    """(B, length, C) -> (B, token_length, C): depthwise-separable k7 conv,
    max-pool 3/3, four dilated blocks (d = 1, 2, 4, 8), then a conv whose
    kernel and stride are (length // 3) // token_length."""

    def __init__(self, token_length: int = 10, *, length: int = 3000,
                 channels: int = 270, generator: torch.Generator):
        super().__init__()
        g = generator
        self.initial_conv = DepthwiseSeparableConv(channels, channels, 7, 3,
                                                   generator=g)
        self.dilated_blocks = nn.ModuleList(
            DilatedConvBlock(channels, d, generator=g) for d in (1, 2, 4, 8))
        k = (length // 3) // token_length
        self.final_conv = Conv1d(channels, channels, k, stride=k,
                                 xavier=False, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool1d(self.initial_conv(x), 3)
        for block in self.dilated_blocks:
            x = block(x)
        return self.final_conv(x)


class TransformerEncoder(nn.Module):
    """Gaussian position + encoder blocks with an outer residual + LN.

    The outer residual is on top of the block's own, so each layer adds its
    input twice (reference ``detr.py:325-326``)."""

    def __init__(self, dim_feature: int, dim_time: int, num_layers: int = 4,
                 *, generator: torch.Generator):
        super().__init__()
        self.layer_embedding_gaussian = GaussianPosition(
            dim_feature, dim_time, generator=generator)
        self.layer_embedding_encoder = nn.ModuleList(
            EncoderBlock(dim_feature, 10, (1,), generator=generator)
            for _ in range(num_layers))
        self.layer_embedding_norm = LayerNorm(dim_feature)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_embedding_gaussian(x)
        for block in self.layer_embedding_encoder:
            x = x + block(x)
        return self.layer_embedding_norm(x)


class TransformerDecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention with
    ``query_pos`` added to its queries and the temperature dividing its
    output, then the FFN. In training, dropout 0.1 applies to both
    attentions' weights, after each of the three sublayers before its
    residual, and after the FFN's ReLU."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 temperature: float = 1.0, *, generator: torch.Generator):
        super().__init__()
        g = generator
        dropout = 0.1
        self.self_attn = MultiheadAttention(d_model, nhead, dropout=dropout,
                                            generator=g)
        self.cross_attn = MultiheadAttention(d_model, nhead, dropout=dropout,
                                             output_scale=temperature,
                                             generator=g)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        # the reference's Sequential(Linear, ReLU, Dropout, Linear), whose
        # indices name the parameters ffn.0 and ffn.3
        self.ffn = nn.Sequential(
            Linear(d_model, dim_feedforward, xavier=False, generator=g),
            nn.ReLU(), Dropout(dropout),
            Linear(dim_feedforward, d_model, xavier=False, generator=g))
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def forward(self, tgt, memory, query_pos, kv=None):
        tgt = self.norm1(tgt + self.dropout1(self.self_attn(tgt, tgt, tgt)))
        t2, kv = self.cross_attn(tgt + query_pos, memory, memory, kv=kv,
                                 return_kv=True)
        tgt = self.norm2(tgt + self.dropout2(t2))
        tgt = self.norm3(tgt + self.dropout3(self.ffn(tgt)))
        return tgt, kv


class TransformerDecoder(nn.Module):
    """Weight-shared decoder: ``decoder_layers`` holds ONE layer object
    ``num_layers`` times, as the reference's ModuleList does, so the state
    dict repeats its tensors under every index. Zero targets; the memory's
    K/V are projected once and reused at every depth. Returns per-layer
    class logits stacked as (L, B, Q, C)."""

    def __init__(self, d_model: int = 270, nhead: int = 6,
                 num_layers: int = 6, num_queries: int = 5,
                 dim_feedforward: int = 512, temperature: float = 1.0,
                 num_classes: int = 10, *, generator: torch.Generator):
        super().__init__()
        self.query_embed = nn.Parameter(torch.empty(num_queries, d_model))
        with torch.no_grad():
            self.query_embed.normal_(generator=generator)
        layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                        temperature, generator=generator)
        self.decoder_layers = nn.ModuleList([layer] * num_layers)
        self.class_embed = Linear(d_model, num_classes, xavier=False,
                                  generator=generator)

    def forward(self, memory: torch.Tensor) -> torch.Tensor:
        query_pos = self.query_embed[None].expand(memory.shape[0], -1, -1)
        output = torch.zeros_like(query_pos)
        preds, kv = [], None
        for layer in self.decoder_layers:
            output, kv = layer(output, memory, query_pos, kv=kv)
            preds.append(self.class_embed(output))
        return torch.stack(preds)


class DETRMultiUser(nn.Module):
    """CNN feature extractor -> transformer encoder -> weight-shared
    decoder: (B, length, 270) windows to (L, B, Q, C) logits."""

    def __init__(self, token_length: int = 10, num_decoder_layers: int = 6,
                 temp_cross: float = 1.0, num_queries: int = 5,
                 dim_feedforward: int = 512, num_classes: int = 10, *,
                 length: int = 3000, channels: int = 270,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.feature_extractor = CNNFeatureExtractor(
            token_length, length=length, channels=channels, generator=g)
        self.encoder = TransformerEncoder(channels, token_length,
                                          generator=g)
        self.decoder = TransformerDecoder(
            d_model=channels, nhead=6, num_layers=num_decoder_layers,
            num_queries=num_queries, dim_feedforward=dim_feedforward,
            temperature=temp_cross, num_classes=num_classes, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(self.feature_extractor(x)))
