"""Per-class sparse ensemble fusion.

Port of the JAX package's ``models/sparse_fusion.SparseModel`` (the
reference's one ``Linear(num_part -> 1)`` per class, train_sparse.py:89-105)
as one contraction over the P part-streams' score for each class:

    y[n, c] = sum_p w[c, p] * x[n, p, c] + b[c]

computed in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

# flax's lecun_normal draws a normal truncated to +-2 standard deviations and
# divides its scale by that distribution's standard deviation, 0.87962566...,
# so the draws have variance exactly 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal()`` on a 2-D (in, out) weight: fan_in is
    ``w.shape[-2]`` (for the (C, P) fusion weight: C, not P). A truncated
    normal by the inverse CDF, as jax.random.truncated_normal draws it,
    from ``generator`` on the CPU."""
    fan_in = w.shape[-2]
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    z = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u)
    with torch.no_grad():
        w.copy_(z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))
    return w


class SparseModel(nn.Module):
    """forward(x (N, P, C)) -> (N, C) float32 fused scores. ``weight`` (C, P)
    starts at flax's lecun_normal drawn from ``generator`` (seed 0 if None),
    ``bias`` (C,) at zero."""

    def __init__(self, num_class: int, num_part: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_class = num_class
        self.num_part = num_part
        self.weight = nn.Parameter(torch.empty(num_class, num_part))
        self.bias = nn.Parameter(torch.zeros(num_class))
        lecun_normal_(self.weight, generator or torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:]) != (self.num_part, self.num_class):
            raise ValueError(f"expected (N, {self.num_part}, {self.num_class}), got "
                             f"{tuple(x.shape)}")
        y = torch.einsum("npc,cp->nc", x.float(), self.weight.float())
        return y + self.bias.float()
