"""Single-pathway 3D ResNet (the reference's ``res3d`` stream model), NCDHW.

Port of the JAX package's ``models/res3d.Res3D``: the slow pathway of the
SlowFast machinery (models/slowfast.py) with no fast pathway and no fusion,
the reference's torchhub ``slow_r50`` with its stem rewired to the 5 BGR+UV
channels (train.py:79-89): stem (1,7,7)/(1,2,2), stages 3-4-6-3 for depth 50
with the slow conv_a kernels, spatial strides (1,2,2,2), temporal stride 1;
then a float32 global average, dropout and ``proj``.

Module names follow pytorchvideo's ``slow_r50`` grammar: ``blocks.0.conv``,
``blocks.{1..4}.res_blocks.{j}.branch2.conv_a``, ``blocks.5.proj``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .slowfast import (MODEL_STAGE_DEPTH, SLOW_CONV_A, SPATIAL_STRIDES, TEMPORAL_STRIDES,
                       ResBasicStem, ResNetBasicHead, ResStage)


class PooledHead(ResNetBasicHead):
    """Float32 global average over (T, H, W), dropout (ResNetBasicHead's),
    then ``proj`` in the input's dtype; float32 logits."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        pooled = self.dropout(x.float().mean(dim=(2, 3, 4)), generator)
        return self.proj(pooled.to(x.dtype)).float()


class Res3D(nn.Module):
    """forward(x (N, 5, T, H, W), generator) -> logits (N, num_classes)
    float32; ``generator`` draws the head's dropout mask in training."""

    def __init__(self, num_classes: int, in_channels: int = 5, stem_dim_out: int = 64,
                 depths=MODEL_STAGE_DEPTH[50], dropout_rate: float = 0.5):
        super().__init__()
        blocks = [ResBasicStem(in_channels, stem_dim_out)]
        dim_in, dim_out = stem_dim_out, stem_dim_out * 4
        for idx, depth in enumerate(depths):
            blocks.append(ResStage(depth, dim_in, dim_out // 4, dim_out, SLOW_CONV_A[idx],
                                   TEMPORAL_STRIDES[idx], SPATIAL_STRIDES[idx]))
            dim_in, dim_out = dim_out, dim_out * 2
        blocks.append(PooledHead(dim_in, num_classes, dropout_rate))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.blocks[:-1]:
            x = block(x)
        return self.blocks[-1](x, generator)


def init_res3d(cfg) -> Res3D:
    return Res3D(num_classes=int(cfg.CHALEARN.NUM_CLASS),
                 depths=MODEL_STAGE_DEPTH[int(cfg.MODEL.DEPTH)])
