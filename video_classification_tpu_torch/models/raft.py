"""RAFT optical flow (Teed & Deng 2020), raft_large: the v2 slice's learned flow.

Port of the JAX package's ``models/raft.py``, held to that function (not to
torchvision's). The modules are named after torchvision's ``raft_large``
state_dict grammar, so a torchvision checkpoint loads with
``load_state_dict`` (``models/raft_convert.py``):

  * ``feature_encoder`` (``fnet``, shared by both images) and
    ``context_encoder`` (``cnet``): conv7x7/2 + 6 residual blocks, 256
    channels at 1/8; InstanceNorm (biased variance, eps 1e-5, no affine) in
    the first, BatchNorm on its running statistics in the second, in every
    mode (the JAX RAFT applies ``cnet`` with ``train=False``);
  * the all-pairs correlation in float32, divided by sqrt(C), one batched
    product; a pyramid of VALID 2x2 average pools that stops before a level
    would have a side below 1 (``correlation_pyramid``);
  * a radius-4 window lookup per level with clamped coordinates
    (``lookup``: x0 = min(floor(x), W_l - 2), window order (dy, dx)
    row-major);
  * ``update_block``: motion encoder, separable (1x5 / 5x1) ConvGRU, flow
    head; ``mask_predictor``: 576 mask channels read as (8, 8, 9), x0.25;
  * 8x convex upsampling of the x8-scaled flow, zero-padded.

Inputs are (N, H, W, 3) images in [0, 1], H and W divisible by 8, scaled to
2x - 1. ``dtype`` is the convolutions' compute dtype; the correlation, the
lookup, the flow and the upsampling stay float32. The JAX function upsamples
after every iteration and keeps the last; here only the last is computed,
which is the same value.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d

BLOCKS = ((64, 64, 1), (64, 64, 1), (64, 96, 2), (96, 96, 1), (96, 128, 2),
          (128, 128, 1))  # (in, out, stride) of the six residual blocks
HIDDEN = 128


def conv(cin: int, cout: int, kernel, stride: int = 1) -> Conv2d:
    """A biased conv padded by k // 2 on each side, computing in its input's
    dtype."""
    k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    return Conv2d(cin, cout, k, stride, padding=(k[0] // 2, k[1] // 2), bias=True)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W of (N, C, H, W): float32
    mean and biased variance, eps 1e-5, no affine; the input's dtype out."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = torch.square(xf - mean).mean(dim=(2, 3), keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class RunningBatchNorm(BatchNorm):
    """``layers.BatchNorm`` that normalizes with its running statistics in
    every mode, with torchvision's ``num_batches_tracked`` buffer (loaded,
    unused)."""

    def __init__(self, num_features: int):
        super().__init__(num_features)
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        inv = torch.rsqrt(self.running_var.to(dt) + self.eps) * self.weight.to(dt)
        shift = self.bias.to(dt) - self.running_mean.to(dt) * inv
        view = (1, -1, 1, 1)
        return x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)


def _norm(kind: str, ch: int) -> nn.Module:
    return RunningBatchNorm(ch) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    """conv-norm-relu twice, a conv-norm projection when the shape changes,
    add, relu (keys ``convnormrelu{1,2}.{0,1}``, ``downsample.{0,1}``)."""

    def __init__(self, cin: int, cout: int, stride: int, norm: str):
        super().__init__()
        self.convnormrelu1 = nn.Sequential(conv(cin, cout, 3, stride), _norm(norm, cout),
                                           nn.ReLU())
        self.convnormrelu2 = nn.Sequential(conv(cout, cout, 3), _norm(norm, cout), nn.ReLU())
        self.downsample = (nn.Sequential(conv(cin, cout, 1, stride), _norm(norm, cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class Encoder(nn.Module):
    """The 1/8-resolution tower: 64 -> 64, 64 -> 96, 96 -> 128, 128 -> 256."""

    def __init__(self, norm: str):
        super().__init__()
        self.convnormrelu = nn.Sequential(conv(3, 64, 7, 2), _norm(norm, 64), nn.ReLU())
        for layer in range(3):
            blocks = [ResidualBlock(cin, cout, s, norm)
                      for cin, cout, s in BLOCKS[2 * layer:2 * layer + 2]]
            setattr(self, f"layer{layer + 1}", nn.Sequential(*blocks))
        self.conv = conv(128, 2 * HIDDEN, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convnormrelu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv(x)


def _conv_relu(cin: int, cout: int, kernel) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, kernel), nn.ReLU())


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convcorr1 = _conv_relu(corr_channels, 256, 1)
        self.convcorr2 = _conv_relu(256, 192, 3)
        self.convflow1 = _conv_relu(2, 128, 7)
        self.convflow2 = _conv_relu(128, 64, 3)
        self.conv = _conv_relu(192 + 64, HIDDEN - 2, 3)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = self.convcorr2(self.convcorr1(corr))
        f = self.convflow2(self.convflow1(flow))
        return torch.cat([self.conv(torch.cat([c, f], dim=1)), flow], dim=1)


class ConvGRU(nn.Module):
    """A ConvGRU of the 128 hidden channels over the 256 input channels
    (context and motion)."""

    def __init__(self, kernel):
        super().__init__()
        self.convz = conv(3 * HIDDEN, HIDDEN, kernel)
        self.convr = conv(3 * HIDDEN, HIDDEN, kernel)
        self.convq = conv(3 * HIDDEN, HIDDEN, kernel)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class RecurrentBlock(nn.Module):
    """The separable ConvGRU: a 1x5 GRU, then a 5x1 GRU."""

    def __init__(self):
        super().__init__()
        self.convgru1 = ConvGRU((1, 5))
        self.convgru2 = ConvGRU((5, 1))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.convgru2(self.convgru1(h, x), x)


class FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(HIDDEN, 256, 3)
        self.conv2 = conv(256, 2, 3)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class UpdateBlock(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.motion_encoder = MotionEncoder(corr_channels)
        self.recurrent_block = RecurrentBlock()
        self.flow_head = FlowHead()

    def forward(self, hidden, context, corr, flow) -> Tuple[torch.Tensor, torch.Tensor]:
        motion = self.motion_encoder(flow, corr)
        hidden = self.recurrent_block(hidden, torch.cat([context, motion], dim=1))
        return hidden, self.flow_head(hidden)


class MaskPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.convrelu = _conv_relu(HIDDEN, 256, 3)
        self.conv = conv(256, 8 * 8 * 9, 1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv(self.convrelu(h)) * 0.25


def correlation_pyramid(f1: torch.Tensor, f2: torch.Tensor,
                        levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation of (N, H, W, C) features -> [(N, H, W, H_l, W_l)]
    per level, float32 as given; stops before a level whose source has a
    side below 2."""
    n, h, w, c = f1.shape
    corr = torch.matmul(f1.reshape(n, h * w, c), f2.reshape(n, h * w, c).transpose(1, 2))
    corr = corr / torch.sqrt(torch.tensor(float(c), dtype=corr.dtype, device=corr.device))
    pyramid = [corr.reshape(n, h, w, h, w)]
    cur = corr.reshape(n * h * w, 1, h, w)
    for _ in range(levels - 1):
        if min(cur.shape[2], cur.shape[3]) < 2:
            break
        cur = F.avg_pool2d(cur, 2, 2)
        pyramid.append(cur.reshape(n, h, w, cur.shape[2], cur.shape[3]))
    return pyramid


def pyramid_levels(h: int, w: int, levels: int = 4) -> int:
    """How many levels ``correlation_pyramid`` builds for H x W images."""
    hl, wl, n = h // 8, w // 8, 1
    while n < levels and min(hl, wl) >= 2:
        hl, wl, n = hl // 2, wl // 2, n + 1
    return n


def lookup(pyramid: List[torch.Tensor], coords: torch.Tensor,
           radius: int = 4) -> torch.Tensor:
    """Bilinear samples of each level in a (2r+1)^2 window around ``coords``
    (N, H, W, 2) = (x, y) at 1/8 resolution -> (N, H, W, levels (2r+1)^2).
    Coordinates clamp to [0, W_l - 1] x [0, H_l - 1]; the window runs
    (dy, dx) row-major."""
    n, h, w, _ = coords.shape
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    window = torch.stack(torch.meshgrid(r, r, indexing="xy"), dim=-1).reshape(-1, 2)
    outs = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[3], corr.shape[4]
        c = corr.reshape(n * h * w, hl * wl)
        ctr = coords.reshape(n * h * w, 2) / (2.0 ** lvl)
        pts = ctr[:, None, :] + window[None, :, :]  # (NHW, K, 2)
        x = torch.clamp(pts[..., 0], 0.0, wl - 1.0)
        y = torch.clamp(pts[..., 1], 0.0, hl - 1.0)
        x0 = torch.clamp(torch.floor(x).to(torch.int64), max=max(wl - 2, 0))
        y0 = torch.clamp(torch.floor(y).to(torch.int64), max=max(hl - 2, 0))
        wx = x - x0
        wy = y - y0
        x1 = torch.clamp(x0 + 1, max=wl - 1)
        y1 = torch.clamp(y0 + 1, max=hl - 1)

        def at(yy, xx):
            return torch.gather(c, 1, yy * wl + xx)

        v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
             + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
        outs.append(v.reshape(n, h, w, -1))
    return torch.cat(outs, dim=-1)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8x convex upsampling: (N, H, W, 2) flow and (N, H, W, 576) mask ->
    (N, 8H, 8W, 2); each output pixel a softmax-weighted combination of the
    3x3 neighbourhood of the x8 flow (zero outside)."""
    n, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(n, h, w, 8, 8, 9), dim=-1)
    fp = F.pad(flow * 8.0, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([fp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)],
                        dim=-1)  # (N, H, W, 2, 9)
    up = torch.einsum("nhwyxk,nhwck->nhwyxc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """(N, H, W, 3) image pairs in [0, 1] -> (the upsampled flow (N, H, W, 2)
    in pixels, the 1/8 flow). ``corr_levels`` sizes the motion encoder's
    input (``levels`` unless given: ``pyramid_levels`` of a small input)."""

    def __init__(self, num_iters: int = 12, radius: int = 4, levels: int = 4,
                 corr_levels: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_iters, self.radius, self.levels, self.dtype = num_iters, radius, levels, dtype
        corr_channels = (levels if corr_levels is None else corr_levels) * (2 * radius + 1) ** 2
        self.feature_encoder = Encoder("instance")
        self.context_encoder = Encoder("batch")
        self.update_block = UpdateBlock(corr_channels)
        self.mask_predictor = MaskPredictor()

    def forward(self, image1: torch.Tensor, image2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = image1.shape[0]

        def nchw(t):
            return t.permute(0, 3, 1, 2)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        x1 = (2.0 * image1.float() - 1.0).to(self.dtype)
        x2 = (2.0 * image2.float() - 1.0).to(self.dtype)
        fmaps = nhwc(self.feature_encoder(nchw(torch.cat([x1, x2], dim=0))))
        cnet = self.context_encoder(nchw(x1))
        hidden = torch.tanh(cnet[:, :HIDDEN])
        context = F.relu(cnet[:, HIDDEN:])

        pyramid = correlation_pyramid(fmaps[:n].float(), fmaps[n:].float(), self.levels)
        h, w = fmaps.shape[1:3]
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x1.device),
                                torch.arange(w, dtype=torch.float32, device=x1.device),
                                indexing="ij")
        grid = torch.stack([xs, ys], dim=-1)[None]  # (1, H, W, 2) base coords (x, y)
        flow = torch.zeros((n, h, w, 2), dtype=torch.float32, device=x1.device)
        for _ in range(self.num_iters):
            corr = lookup(pyramid, grid + flow, self.radius)
            hidden, dflow = self.update_block(hidden, context, nchw(corr.to(self.dtype)),
                                              nchw(flow.to(self.dtype)))
            flow = flow + nhwc(dflow).float()
        mask = nhwc(self.mask_predictor(hidden)).float()
        return convex_upsample(flow, mask), flow


def flow_ops_per_pair(h: int, w: int, num_iters: int = 12) -> float:
    """Multiply-adds x 2 of one image pair's forward at H x W (convolutions,
    correlation, lookup arithmetic, upsampling; four levels, radius 4), for
    the bound of a run."""
    def conv_ops(cin, cout, k, hh, ww):
        return 2.0 * cin * cout * k[0] * k[1] * hh * ww

    h2, w2, h4, w4, h8, w8 = h // 2, w // 2, h // 4, w // 4, h // 8, w // 8
    enc = conv_ops(3, 64, (7, 7), h2, w2)
    sizes = {64: (h2, w2), 96: (h4, w4), 128: (h8, w8)}
    for cin, cout, s in BLOCKS:
        hh, ww = sizes[cout]
        enc += conv_ops(cin, cout, (3, 3), hh, ww) + conv_ops(cout, cout, (3, 3), hh, ww)
        if s != 1 or cin != cout:
            enc += conv_ops(cin, cout, (1, 1), hh, ww)
    enc += conv_ops(128, 256, (1, 1), h8, w8)
    corr_ch = 4 * 81
    it = (conv_ops(corr_ch, 256, (1, 1), h8, w8) + conv_ops(256, 192, (3, 3), h8, w8)
          + conv_ops(2, 128, (7, 7), h8, w8) + conv_ops(128, 64, (3, 3), h8, w8)
          + conv_ops(256, 126, (3, 3), h8, w8)
          + 2 * 3 * conv_ops(384, 128, (1, 5), h8, w8)
          + conv_ops(128, 256, (3, 3), h8, w8) + conv_ops(256, 2, (3, 3), h8, w8)
          + 11.0 * corr_ch * h8 * w8)
    corr = 2.0 * (h8 * w8) ** 2 * 256
    mask = conv_ops(128, 256, (3, 3), h8, w8) + conv_ops(256, 576, (1, 1), h8, w8)
    return 3 * enc + num_iters * it + corr + mask + 2.0 * 9 * 2 * 64 * h8 * w8
