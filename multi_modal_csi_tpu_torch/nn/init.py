"""Initializers with the reference models' distributions, drawn from an
explicit ``torch.Generator`` (counterpart of the JAX package's
``nn/init.py``).

Shapes are in torch's layout: (out, in) for a Linear weight and
(out, in/groups, k) for a Conv1d weight. The fans come out the same as the
JAX package's for its (in, out) and (k, in/groups, out) layouts, so the
bounds agree.
"""

from __future__ import annotations

import math

import torch


def _fans(t: torch.Tensor):
    if t.dim() < 2:
        return t.numel(), t.numel()
    receptive = math.prod(t.shape[2:])
    return t.shape[1] * receptive, t.shape[0] * receptive


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float,
             generator: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def xavier_uniform_(t: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """Glorot/Xavier uniform, gain 1."""
    fan_in, fan_out = _fans(t)
    return uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def torch_linear_weight_(t: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
    """PyTorch's Linear/Conv default, kaiming_uniform(a=sqrt(5)), which is
    uniform(+-1/sqrt(fan_in))."""
    fan_in, _ = _fans(t)
    return uniform_(t, 1.0 / math.sqrt(fan_in) if fan_in else 0.0, generator)


def torch_bias_(t: torch.Tensor, fan_in: int,
                generator: torch.Generator) -> torch.Tensor:
    """PyTorch's Linear/Conv default bias: uniform(+-1/sqrt(fan_in))."""
    return uniform_(t, 1.0 / math.sqrt(fan_in) if fan_in else 0.0, generator)


# flax's truncated_normal variance scaling divides the standard deviation
# by that of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def fan_out_normal_(t: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """flax's ``variance_scaling(2.0, "fan_out", "truncated_normal")`` (the
    JAX package's video ``Conv3D`` init, torchvision's kaiming-normal
    fan-out): a normal of std sqrt(2 / fan_out) / 0.8796..., truncated at
    two of its standard deviations."""
    _, fan_out = _fans(t)
    std = math.sqrt(2.0 / fan_out) / _TRUNCATED_STD
    return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                       generator=generator)
