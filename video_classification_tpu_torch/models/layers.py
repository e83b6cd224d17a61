"""Building blocks of the 3D-CNNs (NCDHW) and the 2D detector (NCHW).

Parameters live in the parameter dtype (float32) and each layer computes in
its input's dtype (the compute dtype, bfloat16 on the card by default), as
the JAX package's layers do. BatchNorm keeps the JAX package's
``BatchNormLean`` arithmetic: x * (rsqrt(var + eps) * scale) + (bias - mean
* that), with float32 batch statistics and the biased variance in training.
GroupNorm keeps flax's arithmetic (float32 statistics, E[x^2] - E[x]^2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running = m * running + (1 - m) * batch


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


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype, then applies an optional
    ``norm`` submodule (detectron2's key grammar: ``<conv>.norm.*``) and an
    optional ReLU."""

    def __init__(self, *args, norm: Optional[nn.Module] = None,
                 relu: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                     self.padding, self.dilation, self.groups)
        if self.norm is not None:
            y = self.norm(y)
        return F.relu(y) if self.relu else y


def conv2d(in_channels: int, out_channels: int, kernel: int, stride: int = 1,
           bias: bool = False, **kwargs) -> Conv2d:
    """Square 2D conv with torch-style k//2 padding."""
    return Conv2d(in_channels, out_channels, kernel, stride,
                  padding=kernel // 2, bias=bias, **kwargs)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.Module):
    """BatchNorm of an (N, C, ...) tensor of any rank, with running
    statistics (weight, bias, running_mean, running_var: the torch
    state_dict names); in eval mode detectron2's FrozenBatchNorm2d is the
    same function.

    Training mode is the JAX package's ``BatchNormLean`` with
    ``use_running_average=False``: float32 batch mean (float64 for a
    float64 input, which only the tests' references use), the **biased**
    variance max(E[x^2] - E[x]^2, 0), and running statistics updated by
    flax's rule m * running + (1 - m) * batch with m = ``BN_MOMENTUM``,
    outside the graph. ``torch.nn.BatchNorm3d`` would store the unbiased
    variance instead."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)  # float64 only for float64 x
        if self.training:
            axes = [0, *range(2, x.dim())]
            xf = x.to(dt)
            mean = xf.mean(dim=axes)
            mean2 = (xf * xf).mean(dim=axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        inv = torch.rsqrt(var + self.eps) * self.weight.to(dt)
        shift = self.bias.to(dt) - mean * inv
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


class GroupNorm(nn.Module):
    """GroupNorm of an (N, C, ...) tensor with flax's arithmetic: float32
    statistics, var = max(E[x^2] - E[x]^2, 0), then
    (x - mean) * (rsqrt(var + eps) * weight) + bias, returned in the input's
    dtype. (torch.nn.GroupNorm's variance differs in the last bits, which can
    flip near-tied chart argmaxes.)"""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        xf = x.float().reshape(n, g, c // g, -1)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        mean2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        view = (1, g, c // g, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.float().view(view)
        y = (xf - mean) * mul + self.bias.float().view(view)
        return y.reshape(x.shape).to(x.dtype)


def max_pool_3d(x, kernel, strides, padding):
    return F.max_pool3d(x, tuple(kernel), tuple(strides), tuple(padding))


def avg_pool_3d(x, kernel):
    """VALID average pool, stride 1."""
    return F.avg_pool3d(x, tuple(kernel), stride=1)
