"""Dual-pathway SlowFast 3D-CNN with the reference's lateral fusion (NCDHW).

Port of the JAX package's ``models/slowfast.py`` (the network the reference
builds through pytorchvideo's ``create_slowfast``, my_slowfast.py:44-126):
BGR+UV (5 ch) on the slow pathway, the 5-frame flow stack (15 ch) on the
fast one; stem dims (64, 8); ResNet depths (3, 4, 6, 3) for depth 50;
``FuseFastToSlow`` after the stem and stages 1-3; per-pathway average pool
clamped to the feature extent, concat, dropout, linear, global mean.

Module names reproduce pytorchvideo's state_dict grammar, e.g.
``blocks.{i}.multipathway_blocks.{p}.res_blocks.{j}.branch2.conv_a``,
``blocks.{i}.multipathway_fusion.conv_fast_to_slow.0`` and
``blocks.6.proj``; ``blocks.5`` (the pool) holds no parameters. The JAX
package's space-to-depth stem and packed fast-pathway convs are TPU
reformulations of these same strided convs and are not needed here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (REMAT_POLICIES, BatchNorm, Linear, avg_pool_3d, checkpointed, conv3d,
                     max_pool_3d)

MODEL_STAGE_DEPTH = {
    18: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
# conv_a (temporal) kernels per stage: slow pathway, then fast pathway.
SLOW_CONV_A = ((1, 1, 1), (1, 1, 1), (3, 1, 1), (3, 1, 1))
FAST_CONV_A = ((3, 1, 1), (3, 1, 1), (3, 1, 1), (3, 1, 1))
SPATIAL_STRIDES = (1, 2, 2, 2)
TEMPORAL_STRIDES = (1, 1, 1, 1)


class ResBasicStem(nn.Module):
    """conv(1,7,7)/(1,2,2) -> BN -> ReLU -> max-pool(1,3,3)/(1,2,2)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = conv3d(in_channels, out_channels, (1, 7, 7), (1, 2, 2))
        self.norm = BatchNorm(out_channels)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return max_pool_3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class BottleneckBlock(nn.Module):
    """conv_a(k_a)/BN/ReLU -> conv_b(1,3,3, spatial stride)/BN/ReLU ->
    conv_c(1,1,1)/BN. Temporal stride rides conv_a, spatial stride conv_b."""

    def __init__(self, dim_in, dim_inner, dim_out, conv_a_kernel,
                 temporal_stride=1, spatial_stride=1):
        super().__init__()
        self.conv_a = conv3d(dim_in, dim_inner, conv_a_kernel,
                             (temporal_stride, 1, 1))
        self.norm_a = BatchNorm(dim_inner)
        self.conv_b = conv3d(dim_inner, dim_inner, (1, 3, 3),
                             (1, spatial_stride, spatial_stride))
        self.norm_b = BatchNorm(dim_inner)
        self.conv_c = conv3d(dim_inner, dim_out, (1, 1, 1))
        self.norm_c = BatchNorm(dim_out)

    def forward(self, x):
        x = F.relu(self.norm_a(self.conv_a(x)))
        x = F.relu(self.norm_b(self.conv_b(x)))
        return self.norm_c(self.conv_c(x))


class ResBlock(nn.Module):
    """branch1 (1x1x1 projection, block 0 only) + bottleneck branch2."""

    def __init__(self, dim_in, dim_inner, dim_out, conv_a_kernel,
                 temporal_stride=1, spatial_stride=1, use_branch1=False):
        super().__init__()
        if use_branch1:
            self.branch1_conv = conv3d(
                dim_in, dim_out, (1, 1, 1),
                (temporal_stride, spatial_stride, spatial_stride))
            self.branch1_norm = BatchNorm(dim_out)
        else:
            self.branch1_conv = None
        self.branch2 = BottleneckBlock(dim_in, dim_inner, dim_out, conv_a_kernel,
                                       temporal_stride, spatial_stride)

    def forward(self, x):
        shortcut = x
        if self.branch1_conv is not None:
            shortcut = self.branch1_norm(self.branch1_conv(x))
        return F.relu(shortcut + self.branch2(x))


class ResStage(nn.Module):
    """Stack of ResBlocks; stride and projection on block 0 only. With
    ``remat`` set ("" or "conv", ``layers.checkpointed``'s policies) and
    gradients enabled, the stage runs under activation checkpointing."""

    def __init__(self, depth, dim_in, dim_inner, dim_out, conv_a_kernel,
                 temporal_stride=1, spatial_stride=1):
        super().__init__()
        self.res_blocks = nn.ModuleList([
            ResBlock(dim_in if j == 0 else dim_out, dim_inner, dim_out,
                     conv_a_kernel,
                     temporal_stride if j == 0 else 1,
                     spatial_stride if j == 0 else 1,
                     use_branch1=(j == 0))
            for j in range(depth)])
        self.remat: Optional[str] = None

    def _blocks(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x

    def forward(self, x):
        if self.remat is None or not torch.is_grad_enabled():
            return self._blocks(x)
        return checkpointed(self._blocks, x, self.remat)


class FuseFastToSlow(nn.Module):
    """The reference's lateral fusion (my_slowfast.py:136-344).

    default: fast -> conv(3,1,1, 2x channels) -> BN -> ReLU, concat onto slow.
    C123:    concat -> bottleneck res_unit -> + residual(1x1x1 conv + ReLU).
    R:       concat -> + residual.
    The residual / res_unit parameters exist only for the modes that run
    them, as in the JAX package."""

    def __init__(self, fusion_dim_in: int, reduction_ratio: int = 8,
                 conv_ratio: int = 2, mode: str = "default"):
        super().__init__()
        if mode not in ("default", "C123", "R"):
            raise ValueError(f"unknown fusion mode {mode!r}")
        self.mode = mode
        fast_in = fusion_dim_in // reduction_ratio
        fast_out = fast_in * conv_ratio
        out = fusion_dim_in + fast_out
        self.conv_fast_to_slow = nn.ModuleList(
            [conv3d(fast_in, fast_out, (3, 1, 1))])
        self.norm = nn.ModuleList([BatchNorm(fast_out)])
        if mode != "default":
            self.residual = nn.Sequential(
                conv3d(fusion_dim_in, out, (1, 1, 1), bias=True), nn.ReLU())
        if mode == "C123":
            # ReLU before BN, as the reference orders it (my_slowfast.py:228-236).
            self.res_unit = nn.Sequential(
                conv3d(out, out // 4, (1, 1, 1), bias=True), nn.ReLU(),
                BatchNorm(out // 4),
                conv3d(out // 4, out // 4, (1, 3, 3), bias=True), nn.ReLU(),
                BatchNorm(out // 4),
                conv3d(out // 4, out, (1, 1, 1), bias=True))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        x_s, x_f = xs
        fuse = F.relu(self.norm[0](self.conv_fast_to_slow[0](x_f)))
        x_s_fuse = torch.cat([x_s, fuse], dim=1)
        if self.mode == "default":
            return [x_s_fuse, x_f]
        residual = self.residual(x_s)
        if self.mode == "C123":
            x_s_fuse = self.res_unit(x_s_fuse)
        return [x_s_fuse + residual, x_f]


class MultiPathWayWithFuse(nn.Module):
    """One pathway module per pathway, then the optional fusion."""

    def __init__(self, pathways: Sequence[nn.Module], fusion=None):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList(pathways)
        self.multipathway_fusion = fusion

    def forward(self, xs):
        xs = [m(x) for m, x in zip(self.multipathway_blocks, xs)]
        if self.multipathway_fusion is not None:
            xs = self.multipathway_fusion(xs)
        return xs


class PoolConcatPathway(nn.Module):
    """Per-pathway AvgPool3d (window clamped to the feature extent so tiny
    inputs stay valid), stride 1, concatenated over channels."""

    def __init__(self, pool_kernels: Sequence[Tuple[int, int, int]]):
        super().__init__()
        self.pool_kernels = [tuple(k) for k in pool_kernels]

    def forward(self, xs):
        pooled = [avg_pool_3d(x, tuple(min(k, d) for k, d in zip(kern, x.shape[2:])))
                  for x, kern in zip(xs, self.pool_kernels)]
        return torch.cat(pooled, dim=1)


class ResNetBasicHead(nn.Module):
    """Dropout -> linear over channels -> global mean over (T, H, W) in f32.

    Dropout is flax's (inverted: kept values scaled by 1 / (1 - rate)) and
    runs only in training mode, with its mask drawn from the ``generator``
    the caller passes (the trainer's, on the model's device); a rate of 0
    turns it off. ``dropout_shard`` (index, count): the batch is shard
    ``index`` of ``count`` equal row blocks of a global batch (a
    data-parallel rank's), so the mask is drawn for the global batch and
    the shard's rows kept."""

    def __init__(self, dim_in: int, num_classes: int, dropout_rate: float):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.dropout_shard = (0, 1)
        self.proj = Linear(dim_in, num_classes)

    def dropout(self, x: torch.Tensor, generator) -> torch.Tensor:
        if not self.training or self.dropout_rate == 0.0:
            return x
        if generator is None:
            raise ValueError("training-mode dropout needs an explicit torch.Generator")
        keep = 1.0 - self.dropout_rate
        index, count = self.dropout_shard
        n = x.shape[0]
        mask = torch.rand((n * count, *x.shape[1:]), generator=generator,
                          device=x.device)[index * n:(index + 1) * n] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.proj(self.dropout(x, generator).permute(0, 2, 3, 4, 1))
        return x.float().mean(dim=(1, 2, 3))


class SlowFast(nn.Module):
    """The full network: forward([slow (N,5,T,H,W), fast (N,15,T,H,W)]) ->
    logits (N, num_classes) float32. ``dropout_rate`` is the head's
    (``blocks[6].dropout_rate``, settable). ``remat`` (False) checkpoints
    each pathway's ResStage with ``remat_policy`` ("" or "conv"), as the
    JAX package's ``TPU.REMAT`` does: activations recomputed in the
    backward instead of kept."""

    def __init__(self, num_classes: int, input_channels=(5, 15),
                 stem_dim_outs=(64, 8), depths=MODEL_STAGE_DEPTH[50],
                 fuse: bool = True, fusion_mode: str = "default",
                 head_pool_kernels=((4, 2, 2), (4, 2, 2)),
                 dropout_rate: float = 0.5, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        slow_dim, fast_dim = stem_dim_outs
        reduction = slow_dim // fast_dim
        fusion_ratio = 2 if fuse else 0

        def fusion(dim):
            return FuseFastToSlow(dim, reduction, mode=fusion_mode) if fuse else None

        blocks = [MultiPathWayWithFuse(
            [ResBasicStem(input_channels[p], stem_dim_outs[p]) for p in range(2)],
            fusion(slow_dim))]
        dim_in, dim_out = slow_dim, slow_dim * 4
        for idx, depth in enumerate(depths):
            slow_in = dim_in + dim_in * fusion_ratio // reduction
            slow = ResStage(depth, slow_in, dim_out // 4, dim_out,
                            SLOW_CONV_A[idx], TEMPORAL_STRIDES[idx],
                            SPATIAL_STRIDES[idx])
            fast = ResStage(depth, dim_in // reduction, dim_out // 4 // reduction,
                            dim_out // reduction, FAST_CONV_A[idx],
                            TEMPORAL_STRIDES[idx], SPATIAL_STRIDES[idx])
            if remat:
                slow.remat = fast.remat = str(remat_policy)
            blocks.append(MultiPathWayWithFuse(
                [slow, fast], fusion(dim_out) if idx + 1 <= 3 else None))
            dim_in, dim_out = dim_out, dim_out * 2
        blocks.append(PoolConcatPathway(head_pool_kernels))
        blocks.append(ResNetBasicHead(dim_in + dim_in // reduction, num_classes,
                                      dropout_rate))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the head's dropout mask in training mode."""
        if len(xs) != 2:
            raise ValueError("two pathways (slow, fast)")
        xs = list(xs)
        for block in self.blocks[:5]:
            xs = block(xs)
        return self.blocks[6](self.blocks[5](xs), generator)


def init_my_slowfast(cfg, input_channels=(5, 15), stem_dim_outs=(64, 8)) -> SlowFast:
    """The reference entry point ``init_my_slowfast`` (my_slowfast.py:44)."""
    return SlowFast(
        num_classes=int(cfg.CHALEARN.NUM_CLASS),
        input_channels=tuple(input_channels),
        stem_dim_outs=tuple(stem_dim_outs),
        depths=MODEL_STAGE_DEPTH[int(cfg.MODEL.DEPTH)],
        fuse=bool(cfg.MODEL.FUSE),
        fusion_mode=str(cfg.MODEL.FUSION_MODE),
        remat=bool(cfg.CUDA.REMAT),
        remat_policy=str(cfg.CUDA.REMAT_POLICY),
    )


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: convs (2D, 3D) and linears N(0, 1/fan_in), biases 0, BN
    identity (weight 1, bias 0, mean 0, var 1). Draws from ``generator`` in
    module order, on the CPU, so a seed gives the same weights everywhere."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) / fan_in ** 0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model
