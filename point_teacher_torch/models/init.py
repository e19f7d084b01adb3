"""Seeded parameter initialisers matching the flax defaults the reference
models use (nn.Conv / nn.Dense: lecun_normal kernels, zero biases)."""
from __future__ import annotations

import math

import torch
from torch import nn

# stddev correction of a normal truncated at +-2 stddev (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(1, fan_in, truncated_normal): fan_in = in * kh * kw.
    The normal is truncated at 2 sigma by redrawing the samples beyond it."""
    fan_in = w[0].numel()
    with torch.no_grad():
        w.normal_(generator=generator)
        flat = w.view(-1)
        # redraw the samples beyond 2 sigma, in index order, until none is left
        idx = (flat.abs() > 2).nonzero().squeeze(1)
        while idx.numel():
            draw = torch.randn(idx.numel(), generator=generator, dtype=w.dtype)
            flat[idx] = draw
            idx = idx[draw.abs() > 2]
        return w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def init_conv_(conv: nn.Conv2d, generator: torch.Generator, std=None, bias: float = 0.0):
    """lecun_normal kernel, or normal(std) when `std` is given; constant bias."""
    with torch.no_grad():
        if std is None:
            lecun_normal_(conv.weight, generator)
        else:
            nn.init.normal_(conv.weight, 0.0, std, generator=generator)
        if conv.bias is not None:
            conv.bias.fill_(bias)


def init_linear_(fc: nn.Linear, generator: torch.Generator):
    with torch.no_grad():
        lecun_normal_(fc.weight, generator)
        fc.bias.zero_()
