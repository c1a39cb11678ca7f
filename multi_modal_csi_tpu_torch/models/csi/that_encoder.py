"""THAT_ENCODER: THAT's two-stream token encoder feeding a weight-shared
DETR decoder with a class head per layer, for serving and training.
Counterpart of the JAX package's ``models/csi/that_encoder.py``; parameter
names follow the reference torch layout (``encoder.layer_left_encoder.0.
layer_attention.in_proj_weight``, ``decoder.decoder_layers.3.ffn.0.weight``,
``decoder.class_embed.6.bias`` ...).

At full width a (B, 3000, 270) window becomes a (B, 420, 270) memory:

- left stream: 20-step average pool to 150 tokens of 270 features, the
  Gaussian position, 4 encoder blocks (10 heads of 27, convs 1, 3, 5),
  LayerNorm;
- right stream: adaptive average pool of time to 270 bins, channels and
  bins swapped, so 270 channel tokens of 270 features, 1 encoder block (10
  heads of 27, convs 1, 2, 3), LayerNorm.

Both streams pass the attention's flash gate, so a forward runs K1 five
times (4 at (B, 150, 10, 27), 1 at (B, 270, 10, 27)) and a training step
K2 five times too. The decoder's 5 queries stay below the gate. The
reference registers the THAT trunk's four head convolutions in this
encoder but never calls them; the port has no such parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn.layers import LayerNorm, Linear, adaptive_avg_pool1d, avg_pool1d
from .detr import TransformerDecoderLayer
from .that import EncoderBlock, GaussianPosition


class THATEncoderMemory(nn.Module):
    """Two-stream token encoder: (B, length, channels) windows to a
    (B, length // pool + channels, channels) memory."""

    def __init__(self, *, length: int = 3000, channels: int = 270,
                 pool: int = 20, num_left_layers: int = 4,
                 num_right_layers: int = 1, generator: torch.Generator):
        super().__init__()
        g = generator
        self.pool, self.channels = pool, channels
        self.layer_left_gaussian = GaussianPosition(channels, length // pool,
                                                    generator=g)
        self.layer_left_encoder = nn.ModuleList(
            EncoderBlock(channels, 10, (1, 3, 5), generator=g)
            for _ in range(num_left_layers))
        self.layer_left_norm = LayerNorm(channels)
        self.layer_right_encoder = nn.ModuleList(
            EncoderBlock(channels, 10, (1, 2, 3), generator=g)
            for _ in range(num_right_layers))
        self.layer_right_norm = LayerNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        left = self.layer_left_gaussian(avg_pool1d(x, self.pool))
        for block in self.layer_left_encoder:
            left = block(left)
        left = self.layer_left_norm(left)

        # time pooled to `channels` bins, then the channels become tokens
        right = adaptive_avg_pool1d(x, self.channels).transpose(1, 2)
        for block in self.layer_right_encoder:
            right = block(right)
        right = self.layer_right_norm(right)
        return torch.cat([left, right], dim=1)


class THATEncoderDecoder(nn.Module):
    """Weight-shared decoder: ``decoder_layers`` holds ONE layer object
    ``num_layers`` times, as the reference's ModuleList does. Zero targets;
    the memory's K/V are projected once and reused at every depth. After
    each layer, the shared ``norm`` and that layer's own class head; after
    the last, the extra head ``class_embed[num_layers]`` on the same output.
    Returns (L + 1, B, Q, C) logits."""

    def __init__(self, d_model: int = 270, nhead: int = 6,
                 num_layers: int = 6, num_queries: int = 5,
                 dim_feedforward: int = 2048, temperature: float = 1.0,
                 num_classes: int = 10, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.query_embed = nn.Parameter(torch.empty(num_queries, d_model))
        with torch.no_grad():
            self.query_embed.normal_(generator=g)
        layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward,
                                        temperature, generator=g)
        self.decoder_layers = nn.ModuleList([layer] * num_layers)
        self.norm = LayerNorm(d_model)
        self.class_embed = nn.ModuleList(
            Linear(d_model, num_classes, xavier=False, generator=g)
            for _ in range(num_layers + 1))

    def forward(self, memory: torch.Tensor) -> torch.Tensor:
        query_pos = self.query_embed[None].expand(memory.shape[0], -1, -1)
        output = torch.zeros_like(query_pos)
        preds, kv = [], None
        for layer, head in zip(self.decoder_layers, self.class_embed):
            output, kv = layer(output, memory, query_pos, kv=kv)
            preds.append(head(self.norm(output)))
        preds.append(self.class_embed[-1](self.norm(output)))
        return torch.stack(preds)


class THATEncoderDETR(nn.Module):
    """The full model: (B, length, channels) windows to (L + 1, B, Q, C)
    logits, with 6 decoder heads over the channel width and a 2048-wide
    FFN, as in the reference (that_encoder.py:458-482)."""

    def __init__(self, temp_cross: float = 1.0, num_queries: int = 5,
                 num_decoder_layers: int = 6, num_classes: int = 10, *,
                 length: int = 3000, channels: int = 270,
                 generator: torch.Generator):
        super().__init__()
        self.encoder = THATEncoderMemory(length=length, channels=channels,
                                         generator=generator)
        self.decoder = THATEncoderDecoder(
            d_model=channels, nhead=6, num_layers=num_decoder_layers,
            num_queries=num_queries, dim_feedforward=2048,
            temperature=temp_cross, num_classes=num_classes,
            generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))
