"""2D bottleneck residual block (NCHW), the unit of the detector's ResNet.

Port of the JAX package's ``models/resnet2d.Bottleneck2d``. Submodules
follow detectron2's ``BottleneckBlock`` names (``conv1..3`` and ``shortcut``,
each with its frozen BN as ``.norm``), so a detectron2 checkpoint loads by
name. ``ResNet50_2D`` (the res2d stream model) comes with the res2d slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, conv2d


class Bottleneck2d(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with frozen BN, residual ReLU.

    ``stride_in_1x1=False`` is the torchvision convention (stride on the
    3x3); ``True`` is the caffe2/MSRA convention of detectron2's released
    backbones (stride on the first 1x1). Padding is k//2."""

    def __init__(self, in_channels: int, dim_inner: int, dim_out: int,
                 stride: int = 1, use_downsample: bool = False,
                 stride_in_1x1: bool = False):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.shortcut = (conv2d(in_channels, dim_out, 1, stride,
                                norm=BatchNorm(dim_out))
                         if use_downsample else None)
        self.conv1 = conv2d(in_channels, dim_inner, 1, s1,
                            norm=BatchNorm(dim_inner), relu=True)
        self.conv2 = conv2d(dim_inner, dim_inner, 3, s3,
                            norm=BatchNorm(dim_inner), relu=True)
        self.conv3 = conv2d(dim_inner, dim_out, 1, norm=BatchNorm(dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(shortcut + self.conv3(self.conv2(self.conv1(x))))
