"""ResNet3D-18 (torchvision's ``r3d_18``) for video: the port of the JAX
package's ``models/video/resnet3d.py``.

The BasicStem (a (3, 7, 7) conv at stride (1, 2, 2)), four stages of two
3x3x3 BasicBlocks (64, 128, 256, 512 features, stride 2 from stage 2 with
a 1x1x1 projection on the residual), the global mean, ``fc`` to 400 and
the task head.

The input is the JAX cache layout (B, T, H, W, 3); activations stay
channels-last. ``ResNet3DBackbone`` carries torchvision's parameter names
(``stem.0``, ``layer1.0.conv1.0``, ``layer2.0.downsample.1``, ``fc``), so
a torchvision (or ``tools/torch_video_refs.py::R3D18Ref``) state dict
loads into ``ResNet3D18.backbone``; the task head (400 -> out) is
``ResNet3D18.task_head``. Every conv is a hooked ``Conv3d`` (JAX's
``Conv3D`` wrapper), so int8 serving quantizes them; its weights are drawn
as JAX draws them (fan-out truncated normal).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.init import fan_out_normal_
from ...nn.layers import BatchNorm, Conv3d, Linear

THW = Tuple[int, int, int]

STAGE_FEATURES = (64, 128, 256, 512)
BACKBONE_CLASSES = 400           # torchvision's Kinetics-400 head


def video_conv(cin: int, cout: int, kernel: THW, stride: THW = (1, 1, 1),
               padding: THW = (0, 0, 0), *,
               generator: torch.Generator) -> Conv3d:
    """A convolution of JAX's ``Conv3D`` wrapper: no bias, hooked for int8
    serving, the fan-out truncated-normal weight."""
    return Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                  bias=False, hooked=True, weight_init=fan_out_normal_,
                  generator=generator)


class BasicBlock(nn.Module):
    """Two 3x3x3 convs with BatchNorm; a 1x1x1 projection with BatchNorm
    on the residual where the stride or the width changes."""

    def __init__(self, cin: int, cout: int, stride: THW, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = nn.Sequential(
            video_conv(cin, cout, (3, 3, 3), stride, (1, 1, 1), generator=g),
            BatchNorm(cout), nn.ReLU())
        self.conv2 = nn.Sequential(
            video_conv(cout, cout, (3, 3, 3), padding=(1, 1, 1),
                       generator=g),
            BatchNorm(cout))
        self.downsample = None
        if stride != (1, 1, 1) or cin != cout:
            self.downsample = nn.Sequential(
                video_conv(cin, cout, (1, 1, 1), stride, generator=g),
                BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet3DBackbone(nn.Module):
    """The backbone up to torchvision's 400-way ``fc``, with torchvision's
    parameter names. Input (B, T, H, W, 3); output (B, 400). ``clip`` is the
    (T, H, W) it serves (the layers take any)."""

    def __init__(self, clip: THW, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.clip = tuple(clip)
        self.stem = nn.Sequential(
            video_conv(3, STAGE_FEATURES[0], (3, 7, 7), (1, 2, 2), (1, 3, 3),
                       generator=g),
            BatchNorm(STAGE_FEATURES[0]), nn.ReLU())
        cin = STAGE_FEATURES[0]
        for i, feat in enumerate(STAGE_FEATURES):
            stride = (1, 1, 1) if i == 0 else (2, 2, 2)
            setattr(self, f"layer{i + 1}", nn.Sequential(
                BasicBlock(cin, feat, stride, generator=g),
                BasicBlock(feat, feat, (1, 1, 1), generator=g)))
            cin = feat
        self.fc = Linear(cin, BACKBONE_CLASSES, xavier=False, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for i in range(len(STAGE_FEATURES)):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(1, 2, 3)))


class ResNet3D18(nn.Module):
    """r3d_18 backbone + task head (Linear(400 -> out_features),
    ``task_head``)."""

    def __init__(self, out_features: int, clip: THW, *,
                 generator: torch.Generator):
        super().__init__()
        self.backbone = ResNet3DBackbone(clip, generator=generator)
        self.task_head = Linear(BACKBONE_CLASSES, out_features, xavier=False,
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.task_head(self.backbone(x))
