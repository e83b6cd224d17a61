"""Building blocks of the 3D-CNNs (NCDHW) and the 2D detector (NCHW).

Parameters live in the parameter dtype (float32) and each layer computes in
its input's dtype (the compute dtype, bfloat16 on the card by default), as
the JAX package's layers do. BatchNorm keeps the JAX package's
``BatchNormLean`` arithmetic: x * (rsqrt(var + eps) * scale) + (bias - mean
* that), with float32 batch statistics and the biased variance in training.
GroupNorm keeps flax's arithmetic (float32 statistics, E[x^2] - E[x]^2).

``checkpointed`` runs a function under activation checkpointing (the JAX
package's ``nn.remat`` of a stage): only its first run may update the
BatchNorm running statistics, as flax's functional ``batch_stats`` are
updated once per step.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import partial
from typing import Callable, Optional, Sequence

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


_local = threading.local()  # per thread: a recomputing stage's flag


@contextmanager
def running_stat_updates(enabled: bool):
    """Within, training-mode BatchNorm updates its running statistics only
    if ``enabled`` (in this thread)."""
    before = getattr(_local, "update_stats", True)
    _local.update_stats = enabled
    try:
        yield
    finally:
        _local.update_stats = before


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
    outside the graph (skipped inside ``running_stat_updates(False)``).
    ``torch.nn.BatchNorm3d`` would store the unbiased variance instead.

    With a ``process_group`` (``set_batchnorm_group``), the moments are
    those of the global batch, as in the JAX package's one global-view
    program: each rank's sums of x and x^2 and its row count are summed over
    the group by ``torch.distributed.nn.functional.all_reduce``, through
    which autograd passes (its backward all-reduces the gradient).
    ``torch.nn.SyncBatchNorm`` is not used: it keeps the unbiased variance.
    A group of one rank computes the same moments as no group, by sums."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _moments(self, xf: torch.Tensor, axes):
        """(E[x], E[x^2]) over ``axes``, and over the group's ranks."""
        if self.process_group is None:
            return xf.mean(dim=axes), (xf * xf).mean(dim=axes)
        from torch.distributed.nn.functional import all_reduce

        c = xf.shape[1]
        count = torch.full((1,), xf.numel() // c, dtype=xf.dtype, device=xf.device)
        sums = torch.cat([xf.sum(dim=axes), (xf * xf).sum(dim=axes), count])
        sums = all_reduce(sums, group=self.process_group)
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)  # float64 only for float64 x
        if self.training:
            axes = [0, *range(2, x.dim())]
            mean, mean2 = self._moments(x.to(dt), axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if getattr(_local, "update_stats", True):
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


def set_batchnorm_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` takes its training moments over
    ``group``'s ranks (a ``torch.distributed`` process group), or, with
    None, over its own batch."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group


REMAT_POLICIES = ("", "conv")


def _save_convolutions(ctx, op, *args, **kwargs):
    """Policy "conv": keep every convolution's output, recompute the rest
    (the JAX package's ``prim.name == "conv_general_dilated"``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(fn: Callable, x, policy: str = ""):
    """``fn(x)`` under ``torch.utils.checkpoint`` (non-reentrant): policy ""
    keeps only the input and recomputes the whole of ``fn`` in the
    backward; "conv" keeps the convolutions' outputs and recomputes the
    BatchNorm, ReLU and add chains between them. BatchNorm updates its
    running statistics only in the first run, not in a recomputation."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy must be one of {REMAT_POLICIES}, got {policy!r}")
    runs = 0

    def run(inp):
        nonlocal runs
        runs += 1
        with running_stat_updates(runs == 1):
            return fn(inp)

    kwargs = {}
    if policy == "conv":
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_convolutions)
    return checkpoint(run, x, use_reentrant=False, **kwargs)


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
