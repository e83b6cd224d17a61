"""Building blocks of the 3D-CNNs (NCDHW).

Parameters live in the parameter dtype (float32) and each layer computes in
its input's dtype (the compute dtype, bfloat16 on the card by default), as
the JAX package's layers do. BatchNorm is the serving (eval) form with the
JAX package's arithmetic: x * (rsqrt(var + eps) * scale) + (bias - mean * that).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


def same_pad(kernel: Sequence[int]):
    """torch-style padding k//2 per dim (exact for odd kernels)."""
    return tuple(k // 2 for k in kernel)


class Conv3d(nn.Conv3d):
    """nn.Conv3d that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv3d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def conv3d(in_channels: int, out_channels: int, kernel, stride=(1, 1, 1),
           bias: bool = False) -> Conv3d:
    """3D conv with torch-style k//2 padding."""
    return Conv3d(in_channels, out_channels, tuple(kernel), tuple(stride),
                  padding=same_pad(kernel), bias=bias)


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm3d(nn.Module):
    """Eval-mode BatchNorm with running statistics (weight, bias,
    running_mean, running_var: the torch state_dict names).

    Training mode is not supported here: the training slice must update the
    running variance with the biased batch variance, as the JAX package does,
    which ``torch.nn.BatchNorm3d`` does not."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm3d here is eval-only; call model.eval()")
        inv = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


def max_pool_3d(x, kernel, strides, padding):
    return F.max_pool3d(x, tuple(kernel), tuple(strides), tuple(padding))


def avg_pool_3d(x, kernel):
    """VALID average pool, stride 1."""
    return F.avg_pool3d(x, tuple(kernel), stride=1)
