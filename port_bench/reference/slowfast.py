"""Plain PyTorch SlowFast-R50, the network of every stream (reference copy).

The dual-pathway 3D ResNet of Feichtenhofer et al. (arXiv:1812.03982) as
the ChaLearn reference builds it through pytorchvideo's ``create_slowfast``
(zc402/video-classification, my_slowfast.py): BGR+UV (5 channels) on the
slow pathway, the 5-frame flow stack (15 channels) on the fast one, stem
widths (64, 8), stages (3, 4, 6, 3), the default fast-to-slow lateral fusion
(conv (3,1,1) to twice the fast width, BN, ReLU, concatenated) after the
stem and stages 1-3, a per-pathway average pool (4, 2, 2) clamped to the
feature extent, dropout, a linear head and a global mean.

Parameter names follow pytorchvideo's state_dict grammar, so one state dict
loads here and into the program under test. Every op is a plain float32
``torch`` call: ``F.conv3d``, ``F.linear``, BatchNorm by its formula (eval:
running statistics; train: the batch's mean and biased variance, as the
reference's flax ``BatchNorm`` keeps it). Callers turn TF32 off
(``reference.precision.strict_float32``).

``Quant`` puts a lower precision on every convolution and the linear head
(the control of the correctness check, ``reference.precision``): its
``cast`` rounds their operands, and ``grad_cast`` their output gradients.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STAGE_DEPTHS = {18: (1, 1, 1, 1), 50: (3, 4, 6, 3)}
SLOW_CONV_A = ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1))
FAST_CONV_A = ((3, 1, 1), (3, 1, 1), (3, 1, 1), (3, 1, 1))
SPATIAL_STRIDES = (1, 2, 2, 2)
BN_EPS = 1e-5
HEAD_POOL = (4, 2, 2)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient rounded by ``fn`` in the backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class _Round(torch.autograd.Function):
    """``fn`` forward; the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Quant:
    """The precision of the convolutions, the head and BatchNorm: None for
    float32, else ``cast`` rounds each operand of a convolution or the head
    and each output of BatchNorm (the gradient passes straight through), and
    ``grad_cast`` the gradient of each of their outputs."""

    def __init__(self, cast=None, grad_cast=None):
        self.cast = cast
        self.grad_cast = grad_cast

    def operand(self, x):
        return x if self.cast is None else _Round.apply(x, self.cast)

    def output(self, y):
        return y if self.grad_cast is None else _RoundGrad.apply(y, self.grad_cast)

    def activation(self, y):
        return self.output(self.operand(y))


FLOAT32 = Quant()


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel, stride=(1, 1, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.stride = tuple(stride)
        self.padding = tuple(k // 2 for k in kernel)
        self.quant = FLOAT32

    def forward(self, x):
        q = self.quant
        return q.output(F.conv3d(q.operand(x), q.operand(self.weight), None,
                                 self.stride, self.padding))


class Norm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.quant = FLOAT32

    def forward(self, x):
        if self.training:
            axes = [0, 2, 3, 4]
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        shift = self.bias - mean * inv
        return self.quant.activation(x * inv.view(1, -1, 1, 1, 1) + shift.view(1, -1, 1, 1, 1))


class Stem(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, (1, 7, 7), (1, 2, 2))
        self.norm = Norm(cout)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Bottleneck(nn.Module):
    def __init__(self, cin, inner, cout, kernel_a, stride):
        super().__init__()
        self.conv_a = Conv(cin, inner, kernel_a)
        self.norm_a = Norm(inner)
        self.conv_b = Conv(inner, inner, (1, 3, 3), (1, stride, stride))
        self.norm_b = Norm(inner)
        self.conv_c = Conv(inner, cout, (1, 1, 1))
        self.norm_c = Norm(cout)

    def forward(self, x):
        x = F.relu(self.norm_a(self.conv_a(x)))
        x = F.relu(self.norm_b(self.conv_b(x)))
        return self.norm_c(self.conv_c(x))


class Block(nn.Module):
    def __init__(self, cin, inner, cout, kernel_a, stride, project):
        super().__init__()
        if project:
            self.branch1_conv = Conv(cin, cout, (1, 1, 1), (1, stride, stride))
            self.branch1_norm = Norm(cout)
        else:
            self.branch1_conv = None
        self.branch2 = Bottleneck(cin, inner, cout, kernel_a, stride)

    def forward(self, x):
        short = x if self.branch1_conv is None else self.branch1_norm(self.branch1_conv(x))
        return F.relu(short + self.branch2(x))


class Stage(nn.Module):
    def __init__(self, depth, cin, inner, cout, kernel_a, stride):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            [Block(cin if j == 0 else cout, inner, cout, kernel_a,
                   stride if j == 0 else 1, j == 0) for j in range(depth)])
        self.checkpoint = False

    def forward(self, x):
        for block in self.res_blocks:
            if self.checkpoint and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x


class Fuse(nn.Module):
    def __init__(self, slow_dim, ratio=8):
        super().__init__()
        fast = slow_dim // ratio
        self.conv_fast_to_slow = nn.ModuleList([Conv(fast, 2 * fast, (3, 1, 1))])
        self.norm = nn.ModuleList([Norm(2 * fast)])

    def forward(self, xs):
        s, f = xs
        fuse = F.relu(self.norm[0](self.conv_fast_to_slow[0](f)))
        return [torch.cat([s, fuse], dim=1), f]


class Pathways(nn.Module):
    def __init__(self, paths, fusion=None):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList(paths)
        self.multipathway_fusion = fusion

    def forward(self, xs):
        xs = [m(x) for m, x in zip(self.multipathway_blocks, xs)]
        return xs if self.multipathway_fusion is None else self.multipathway_fusion(xs)


class Pool(nn.Module):
    def forward(self, xs):
        return torch.cat([F.avg_pool3d(x, tuple(min(k, d) for k, d in zip(HEAD_POOL, x.shape[2:])),
                                       stride=1) for x in xs], dim=1)


class Head(nn.Module):
    def __init__(self, cin, classes):
        super().__init__()
        self.proj = nn.Linear(cin, classes)
        self.quant = FLOAT32
        self.dropout_rate = 0.5

    def forward(self, x, generator: Optional[torch.Generator]):
        if self.training and self.dropout_rate:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), device=x.device))
        q = self.quant
        y = q.output(F.linear(q.operand(x.permute(0, 2, 3, 4, 1)),
                              q.operand(self.proj.weight), self.proj.bias))
        return y.mean(dim=(1, 2, 3))


class SlowFast(nn.Module):
    """forward([slow (N, 5, T, H, W), fast (N, 15, T, H, W)]) -> (N, classes)
    logits. In training mode the head's dropout draws its mask from the
    ``generator`` given."""

    def __init__(self, classes: int, depth: int = 50, in_channels=(5, 15),
                 stem=(64, 8)):
        super().__init__()
        ratio = stem[0] // stem[1]
        blocks = [Pathways([Stem(in_channels[p], stem[p]) for p in range(2)], Fuse(stem[0]))]
        dim_in, dim_out = stem[0], stem[0] * 4
        for i, depth_i in enumerate(STAGE_DEPTHS[depth]):
            slow = Stage(depth_i, dim_in + 2 * dim_in // ratio, dim_out // 4, dim_out,
                         SLOW_CONV_A[i], SPATIAL_STRIDES[i])
            fast = Stage(depth_i, dim_in // ratio, dim_out // 4 // ratio, dim_out // ratio,
                         FAST_CONV_A[i], SPATIAL_STRIDES[i])
            blocks.append(Pathways([slow, fast], Fuse(dim_out) if i < 3 else None))
            dim_in, dim_out = dim_out, dim_out * 2
        blocks.append(Pool())
        blocks.append(Head(dim_in + dim_in // ratio, classes))
        self.blocks = nn.ModuleList(blocks)

    def set_quant(self, quant: Quant) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, Head, Norm)):
                m.quant = quant

    def set_checkpoint(self, on: bool) -> None:
        """Recompute each residual block in the backward (plain
        ``torch.utils.checkpoint``), so a batch's float32 activations fit."""
        for m in self.modules():
            if isinstance(m, Stage):
                m.checkpoint = on

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        xs: List[torch.Tensor] = list(xs)
        for block in self.blocks[:5]:
            xs = block(xs)
        return self.blocks[6](self.blocks[5](xs), generator)


NORM_MEAN, NORM_STD = 0.45, 0.225


def normalize(x_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 -> (x / 255 - 0.45) / 0.225 in float32 (chalearn_dataset.py)."""
    return (x_uint8.float() * (1.0 / 255.0) - NORM_MEAN) * (1.0 / NORM_STD)


def pathways(clips_uint8: torch.Tensor, offsets: Optional[torch.Tensor] = None,
             size: Optional[int] = None):
    """(N, T, H, W, 21) uint8 clips -> [slow (N, 5, T, S, S), fast (N, 15, T,
    S, S)] float32: channels 0:5 (BGR, U, V) and 5:20 (the flow stack),
    normalized; with ``offsets`` (N, 2) each clip is cut by torchvision's
    RandomCrop: zero-padded by size // 10 (in normalized space), then the
    (size, size) window at (oy, ox)."""
    out = []
    for lo, hi in ((0, 5), (5, 20)):
        x = normalize(clips_uint8[..., lo:hi])
        if offsets is not None:
            pad = size // 10
            x = F.pad(x, (0, 0, pad, pad, pad, pad))
            x = torch.stack([x[n, :, oy:oy + size, ox:ox + size]
                             for n, (oy, ox) in enumerate(offsets.tolist())])
        out.append(x.permute(0, 4, 1, 2, 3).contiguous())
    return out
