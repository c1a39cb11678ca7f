"""Training augmentation (counterpart of the JAX package's
``train/augment.py``), drawn on the batch's device from the step's
generator:

1. additive gaussian noise, sigma 0.1;
2. a per-sample uniform scale in [0.9, 1.1);
3. an elementwise keep-mask, each element kept with probability 0.96.
"""

from __future__ import annotations

import torch


def apply_augmentation(x: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    noise = torch.randn(x.shape, generator=generator, device=x.device)
    x = x + (noise * 0.1).to(x.dtype)
    scale_shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(scale_shape, generator=generator, device=x.device)
    x = x * (0.9 + 0.2 * u).to(x.dtype)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 0.96
    return x * keep.to(x.dtype)
