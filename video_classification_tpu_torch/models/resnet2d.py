"""2D bottleneck ResNets (NCHW): the detector's block and the res2d model.

Port of the JAX package's ``models/resnet2d.py``:

  * ``Bottleneck2d``, the unit of the detector's ResNet. Submodules follow
    detectron2's ``BottleneckBlock`` names (``conv1..3`` and ``shortcut``,
    each with its frozen BN as ``.norm``), so a detectron2 checkpoint loads
    by name.
  * ``ResNet50_2D``, the reference's ``res2d`` stream model: torchvision's
    resnet50 with ``conv1`` rewired to T*5 input channels (train.py:64-76),
    the clip's frames stacked into channels in T-major order. Its names
    follow torchvision's grammar (``conv1``, ``bn1``, ``layer{s}.{j}.conv1``,
    ``layer{s}.{j}.downsample.{0,1}``, ``fc``), which the JAX package's
    ``models/torch_convert.py`` inverts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Linear, conv2d
from .slowfast import MODEL_STAGE_DEPTH


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


class Bottleneck(nn.Module):
    """torchvision's resnet Bottleneck (stride on the 3x3), with the port's
    BatchNorm (train-mode statistics as the JAX package's)."""

    def __init__(self, in_channels: int, dim_inner: int, dim_out: int, stride: int = 1,
                 use_downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(in_channels, dim_inner, 1)
        self.bn1 = BatchNorm(dim_inner)
        self.conv2 = conv2d(dim_inner, dim_inner, 3, stride)
        self.bn2 = BatchNorm(dim_inner)
        self.conv3 = conv2d(dim_inner, dim_out, 1)
        self.bn3 = BatchNorm(dim_out)
        self.downsample = (nn.Sequential(conv2d(in_channels, dim_out, 1, stride),
                                         BatchNorm(dim_out))
                           if use_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(shortcut + self.bn3(self.conv3(y)))


class ResNet50_2D(nn.Module):
    """forward(x (N, T*5, H, W), generator=None) -> logits (N, num_classes)
    float32: conv1 7x7/2, bn1, ReLU, 3x3/2 max-pool (padding 1), the
    bottleneck stages, a float32 global average and ``fc`` in the input's
    dtype. It has no dropout; ``generator`` is accepted for the trainer's
    call and unused."""

    def __init__(self, num_classes: int, in_channels: int = 50,
                 depths=MODEL_STAGE_DEPTH[50]):
        super().__init__()
        self.conv1 = conv2d(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        dim_in, dim_inner, dim_out = 64, 64, 256
        for stage, depth in enumerate(depths):
            blocks = []
            for j in range(depth):
                blocks.append(Bottleneck(dim_in, dim_inner, dim_out,
                                         stride=2 if (stage > 0 and j == 0) else 1,
                                         use_downsample=(j == 0)))
                dim_in = dim_out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            dim_inner, dim_out = dim_inner * 2, dim_out * 2
        self.num_stages = len(depths)
        self.fc = Linear(dim_in, num_classes)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = x.dtype
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.float().mean(dim=(2, 3)).to(dt)).float()


def init_res2d(cfg) -> ResNet50_2D:
    """The res2d model of a config: CLIP_LEN * 5 input channels."""
    return ResNet50_2D(num_classes=int(cfg.CHALEARN.NUM_CLASS),
                       in_channels=int(cfg.CHALEARN.CLIP_LEN) * 5,
                       depths=MODEL_STAGE_DEPTH[int(cfg.MODEL.DEPTH)])
