"""Training augmentation (counterpart of the JAX package's
``train/augment.py``), drawn on the batch's device from the step's
generator:

1. additive gaussian noise, sigma 0.1;
2. a per-sample uniform scale in [0.9, 1.1);
3. an elementwise keep-mask, each element kept with probability 0.96.

Inside a data-parallel step each draw is made at the global batch's shape
and cut to this rank's rows (``parallel/collectives.py::local_rows``), so
N ranks augment as one rank augments the whole batch.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import global_rows, local_rows


def apply_augmentation(x: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    def draw(sample, shape):
        return local_rows(sample(global_rows(shape), generator=generator,
                                 device=x.device))

    noise = draw(torch.randn, x.shape)
    x = x + (noise * 0.1).to(x.dtype)
    u = draw(torch.rand, (x.shape[0],) + (1,) * (x.dim() - 1))
    x = x * (0.9 + 0.2 * u).to(x.dtype)
    keep = draw(torch.rand, x.shape) < 0.96
    return x * keep.to(x.dtype)
