"""S3D (separable 3-D convolutions, torchvision's ``s3d``) for video: the
port of the JAX package's ``models/video/s3d.py``.

Temporally separable convs (a spatial (1, k, k) conv, then a temporal
(k, 1, 1) one, each with BatchNorm and ReLU), two stem stages with max
pools, and the Inception-v1 stack of mixed blocks (3b to 5c) whose 3x3
branches are separable, ending in torchvision's head: a sliding (2, 7, 7)
average pool at stride 1 (its window clipped to the features' size, as
JAX clips it for small clips), Dropout(0.2), the 1x1x1 ``classifier`` to
400 classes over every position, and the mean over the positions. Then
the task head.

BatchNorm here is flax's momentum 0.999 (the torch convention's
1 - 0.999) with eps 1e-3, as JAX's ``ConvBN``. Every conv is a hooked
``Conv3d`` (JAX's ``Conv3D`` wrapper), so int8 serving quantizes those
that are large enough.

The input is the JAX cache layout (B, T, H, W, 3); activations stay
channels-last. ``S3DBackbone`` carries torchvision's parameter names
(``features.{0..15}``, ``branch0`` .. ``branch3``, ``classifier.1``), so a
torchvision state dict loads into ``S3D.backbone``, its 1x1x1 classifier
conv (400, 1024, 1, 1, 1) reshaped to the Linear's (400, 1024)
(``runners/video.py::load_video_pretrained``); the task head (400 -> out)
is ``S3D.task_head``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...nn.layers import BatchNorm, Dropout, Linear, avg_pool3d, max_pool3d
from .resnet3d import video_conv

THW = Tuple[int, int, int]

BN_MOMENTUM = 1.0 - 0.999        # flax's 0.999 in torch's convention
BN_EPS = 1e-3
BACKBONE_CLASSES = 400
DROPOUT = 0.2
HEAD_POOL = (2, 7, 7)            # torchvision's AvgPool3d, stride 1

# Inception-v1 channel plan (mixed_3b .. mixed_5c): branch 1, the reduce
# and the output of branch 2, of branch 3, and branch 4; "pool" and
# "pool2" are the max pools between them
MIXED_CFG = [
    (64, 96, 128, 16, 32, 32),      # 3b -> 256
    (128, 128, 192, 32, 96, 64),    # 3c -> 480
    "pool",
    (192, 96, 208, 16, 48, 64),     # 4b -> 512
    (160, 112, 224, 24, 64, 64),    # 4c -> 512
    (128, 128, 256, 24, 64, 64),    # 4d -> 512
    (112, 144, 288, 32, 64, 64),    # 4e -> 528
    (256, 160, 320, 32, 128, 128),  # 4f -> 832
    "pool2",
    (256, 160, 320, 32, 128, 128),  # 5b -> 832
    (384, 192, 384, 48, 128, 128),  # 5c -> 1024
]
POOLS = {"pool": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         "pool2": ((2, 2, 2), (2, 2, 2), (0, 0, 0))}


class MaxPool3d(nn.Module):
    """Max pooling on channels-last (B, T, H, W, C) (no parameters)."""

    def __init__(self, kernel: THW, stride: THW, padding: THW):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(x, self.kernel, self.stride, self.padding)


class ConvBN(nn.Sequential):
    """torchvision's Conv3dNormActivation: conv (``0``), BatchNorm (``1``),
    ReLU."""

    def __init__(self, cin: int, cout: int, kernel: THW,
                 stride: THW = (1, 1, 1), padding: THW = (0, 0, 0), *,
                 generator: torch.Generator):
        super().__init__(
            video_conv(cin, cout, kernel, stride, padding,
                       generator=generator),
            BatchNorm(cout, momentum=BN_MOMENTUM, eps=BN_EPS), nn.ReLU())


class SepConv(nn.Sequential):
    """Temporally separable conv: spatial (1, k, k) (``0``), then temporal
    (k, 1, 1) (``1``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, *, generator: torch.Generator):
        g = generator
        super().__init__(
            ConvBN(cin, cout, (1, kernel, kernel), (1, stride, stride),
                   (0, padding, padding), generator=g),
            ConvBN(cout, cout, (kernel, 1, 1), (stride, 1, 1),
                   (padding, 0, 0), generator=g))


class MixedBlock(nn.Module):
    """Inception block with separable 3x3 branches (torchvision's
    SepInceptionBlock3D); the four branches concatenated on channels."""

    def __init__(self, cin: int, cfg: Sequence[int], *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        b1, b2a, b2b, b3a, b3b, b4 = cfg
        self.branch0 = ConvBN(cin, b1, (1, 1, 1), generator=g)
        self.branch1 = nn.Sequential(ConvBN(cin, b2a, (1, 1, 1), generator=g),
                                     SepConv(b2a, b2b, generator=g))
        self.branch2 = nn.Sequential(ConvBN(cin, b3a, (1, 1, 1), generator=g),
                                     SepConv(b3a, b3b, generator=g))
        self.branch3 = nn.Sequential(
            MaxPool3d((3, 3, 3), (1, 1, 1), (1, 1, 1)),
            ConvBN(cin, b4, (1, 1, 1), generator=g))
        self.width = b1 + b2b + b3b + b4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x),
                          self.branch2(x), self.branch3(x)], dim=-1)


class S3DBackbone(nn.Module):
    """The backbone up to torchvision's 400-way classifier and the mean
    over positions, with torchvision's parameter names. Input (B, T, H, W,
    3); output (B, 400). ``clip`` is the (T, H, W) it serves."""

    def __init__(self, clip: THW, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.clip = tuple(clip)
        layers = [SepConv(3, 64, 7, 2, 3, generator=g),
                  MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1)),
                  ConvBN(64, 64, (1, 1, 1), generator=g),
                  SepConv(64, 192, generator=g),
                  MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))]
        width = 192
        for cfg in MIXED_CFG:
            if isinstance(cfg, str):
                layers.append(MaxPool3d(*POOLS[cfg]))
            else:
                layers.append(MixedBlock(width, cfg, generator=g))
                width = layers[-1].width
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Dropout(DROPOUT),
            Linear(width, BACKBONE_CLASSES, xavier=False, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        window = tuple(min(k, s) for k, s in zip(HEAD_POOL, x.shape[1:4]))
        x = self.classifier(avg_pool3d(x, window))
        return x.mean(dim=(1, 2, 3))


class S3D(nn.Module):
    """S3D backbone + task head (Linear(400 -> out_features),
    ``task_head``)."""

    def __init__(self, out_features: int, clip: THW, *,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = S3DBackbone(clip, generator=generator)
        self.task_head = Linear(BACKBONE_CLASSES, out_features, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.task_head(self.backbone(x))
