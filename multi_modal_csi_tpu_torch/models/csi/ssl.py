"""SimCLR-style self-supervised model over CSI windows (counterpart of the
JAX package's ``models/csi/ssl.py``; reference
``wifi_csi/model/SSL_model.py:28-274``).

- ``SSLModel``: the CNN-1D trunk with a 512-wide output as ``backbone``;
  the projector Linear(512 -> 256, no bias), BatchNorm, ReLU,
  Linear(256 -> 256, no bias), BatchNorm as ``projector.{0,1,3,4}``; and
  ``online_head``, a Linear on the detached backbone output. The
  parameter names are the reference's (JAX ``core/torch_import.py:344-353``
  maps them).
- ``info_nce`` and ``ssl_loss``: InfoNCE at temperature 0.1 over
  L2-normalised projections (the norm clipped at 1e-12), symmetric and
  halved, plus the online head's BCE. On one device there is no gather
  (the gather over a mesh waits for ROADMAP item 14).
- ``two_views``: the reference's TimeSeriesTransform as per-sample gated
  jitter (0.05 x N(0, 1)), elementwise scale (U(0.9, 1.1)) and a 10-step
  segment mask, with the probabilities (.8, .7, .6) for view 1 and
  (.9, .8, .5) for view 2, applied in that order, each draw from an
  explicit ``torch.Generator`` on the batch's device. The draws are not
  JAX's; their distributions and order are.

In training composition the backbone runs on both views, so its BatchNorm
running statistics update twice a step (view 1, then view 2), and so do
the projector's, as under flax's mutable ``batch_stats``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...losses.basic import bce_with_logits
from ...nn.layers import BatchNorm, Linear
from .cnn_1d import CNN1D

VIEW_PROBS = ((0.8, 0.7, 0.6), (0.9, 0.8, 0.5))   # jitter, scale, mask
NOISE_LEVEL, SCALE_RANGE, MASK_LEN = 0.05, (0.9, 1.1), 10
EMBED_DIM, PROJ_DIM = 512, 256   # backbone output, projector width
TEMPERATURE = 0.1                 # InfoNCE's


class SSLModel(nn.Module):
    """``forward(y1, y2)`` in training composition returns (z1, z2,
    logits); ``forward(y1)`` (or ``inference=True``) returns the online
    head's logits from the backbone in eval mode."""

    def __init__(self, out_features: int, *, channels: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.backbone = CNN1D(EMBED_DIM, channels=channels, generator=g)
        self.projector = nn.Sequential(
            Linear(EMBED_DIM, PROJ_DIM, bias=False, xavier=False,
                   generator=g),
            BatchNorm(PROJ_DIM), nn.ReLU(),
            Linear(PROJ_DIM, PROJ_DIM, bias=False, xavier=False,
                   generator=g),
            BatchNorm(PROJ_DIM))
        self.online_head = Linear(EMBED_DIM, out_features, xavier=False,
                                  generator=g)

    def forward(self, y1: torch.Tensor, y2: Optional[torch.Tensor] = None,
                inference: bool = False):
        if inference or y2 is None:
            training = self.backbone.training
            self.backbone.eval()
            try:
                r1 = self.backbone(y1)
            finally:
                self.backbone.train(training)
            return self.online_head(r1.detach())
        r1 = self.backbone(y1)
        r2 = self.backbone(y2)
        z1, z2 = self.projector(r1), self.projector(r2)
        return z1, z2, self.online_head(r1.detach())


def _normalise(a: torch.Tensor) -> torch.Tensor:
    return a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(
        1e-12)


def info_nce(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """InfoNCE(a -> b) of L2-normalised rows, in f32."""
    a, b = _normalise(a.float()), _normalise(b.float())
    logits = a @ b.T / TEMPERATURE
    return -torch.log_softmax(logits, dim=-1).diagonal().mean()


def ssl_loss(z1: torch.Tensor, z2: torch.Tensor, logits: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, contrastive part): symmetric InfoNCE / 2 plus the online
    head's BCE against the flattened labels."""
    loss_ssl = info_nce(z1, z2) / 2 + info_nce(z2, z1) / 2
    labels = labels.reshape(-1, logits.shape[-1])
    return loss_ssl + bce_with_logits(logits, labels), loss_ssl


def _one_view(generator: torch.Generator, x: torch.Tensor,
              probs: Tuple[float, float, float]) -> torch.Tensor:
    b, t = x.shape[:2]
    dev = x.device

    def gate(p):
        u = torch.rand(b, generator=generator, device=dev)
        return (u < p).view(b, *([1] * (x.dim() - 1)))

    jitter = gate(probs[0])
    noise = torch.randn(x.shape, generator=generator, device=dev,
                        dtype=x.dtype)
    x = torch.where(jitter, x + noise * NOISE_LEVEL, x)
    scale = gate(probs[1])
    factor = torch.empty(x.shape, device=dev, dtype=x.dtype).uniform_(
        *SCALE_RANGE, generator=generator)
    x = torch.where(scale, x * factor, x)
    mask = gate(probs[2])
    start = torch.randint(0, max(t - MASK_LEN, 1), (b, 1),
                          generator=generator, device=dev)
    steps = torch.arange(t, device=dev)[None]
    keep = ((steps < start) | (steps >= start + MASK_LEN)).to(x.dtype)
    return torch.where(mask, x * keep.view(b, t, *([1] * (x.dim() - 2))),
                       x)


def two_views(generator: torch.Generator, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two augmented views of a (B, T, C) batch."""
    return (_one_view(generator, x, VIEW_PROBS[0]),
            _one_view(generator, x, VIEW_PROBS[1]))
