"""Coarse-to-fine variational optical flow, batched over frame pairs.

Port of the JAX package's ``ops/flow.py``: a Gaussian pyramid with downsample
``ratio`` (0.75) down to ``min_width`` (20); per level the fused solve of
``ops/flow_level.py`` (kernel K1 on the card: ``n_outer`` relinearisations,
each ``n_sor`` red-black SOR sweeps); flow upsampled between levels.

Tensors are channels-last (B, H, W, C) at the public functions, as in the
JAX package. The pyramid's bilinear resize matches ``jax.image.resize(...,
"linear")``, which antialiases when it downsamples.

``encode_flow_uint8`` is the on-disk encoding of the reference
(chalearn_video_to_flow.py:79-101): U, V clipped to +-5 -> [0, 1], magnitude
sqrt((U/5)^2 + (V/5)^2)/sqrt(2), all x255 and truncated to uint8.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .flow_level import flow_level


class FlowParams(NamedTuple):
    alpha: float = 0.012
    ratio: float = 0.75
    min_width: int = 20
    n_outer: int = 7
    n_inner: int = 1
    n_sor: int = 30
    omega: float = 1.8        # SOR over-relaxation
    eps: float = 1e-6         # Charbonnier epsilon^2
    warp_radius: int = 8      # warp offsets clamp at +-this many pixels
    # A pair's level stops once an outer moves it by <= this (px); 0 = always
    # run n_outer. The uint8 encoding's step is 10/255 ~ 0.039 px.
    fuse_outer_tol: float = 0.005


DEFAULT_PARAMS = FlowParams()


def _edge_pad(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1).expand(*[r if d == dim else -1
                                         for d in range(x.dim())])
    last = x.narrow(dim, n - 1, 1).expand(*[r if d == dim else -1
                                            for d in range(x.dim())])
    return torch.cat([first, x, last], dim)


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over (B, H, W, C), edge-replicated."""
    radius = max(1, int(math.ceil(2.0 * sigma)))
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=x.device)
    k = torch.exp(-0.5 * (offsets / sigma) ** 2)
    k = k / torch.sum(k)

    def blur_axis(v, dim):
        vp = _edge_pad(v, dim, radius)
        out = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            out = out + k[i] * vp.narrow(dim, i, v.shape[dim])
        return out

    return blur_axis(blur_axis(x, 1), 2)


def _resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), half-pixel centres, antialiased when
    downsampling (``jax.image.resize(..., "linear")``)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _pyramid_shapes(h: int, w: int, ratio: float, min_width: int):
    """Level shapes, finest first (level 0 = original)."""
    shapes = [(h, w)]
    while True:
        nh, nw = int(round(shapes[-1][0] * ratio)), int(round(shapes[-1][1] * ratio))
        if min(nh, nw) < min_width:
            break
        shapes.append((nh, nw))
    return shapes


def coarse2fine_flow(im1: torch.Tensor, im2: torch.Tensor,
                     params: FlowParams = DEFAULT_PARAMS):
    """Dense flow for a batch of frame pairs.

    im1, im2: (B, H, W, C) in [0, 1]. Returns (u, v), each (B, H, W) float32,
    in pixels."""
    if params.n_inner != 1:
        raise NotImplementedError(
            "n_inner != 1 runs the unfused per-op flow path (the Pallas "
            "`_sor_kernel`, K4), which is not ported yet")
    im1 = im1.float()
    im2 = im2.float()
    b, h, w, _ = im1.shape
    shapes = _pyramid_shapes(h, w, params.ratio, params.min_width)

    sigma = (1.0 / params.ratio - 1.0) + 0.3
    pyr1, pyr2 = [im1.contiguous()], [im2.contiguous()]
    for hw in shapes[1:]:
        pyr1.append(_resize_bilinear(_gaussian_blur(pyr1[-1], sigma), hw))
        pyr2.append(_resize_bilinear(_gaussian_blur(pyr2[-1], sigma), hw))

    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=torch.float32, device=im1.device)
    v = torch.zeros_like(u)
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if (u.shape[1], u.shape[2]) != (th, tw):
            scale_x = tw / u.shape[2]
            scale_y = th / u.shape[1]
            u = _resize_bilinear(u[..., None], (th, tw))[..., 0] * scale_x
            v = _resize_bilinear(v[..., None], (th, tw))[..., 0] * scale_y
        u, v, _ = flow_level(pyr1[lvl], pyr2[lvl], u.contiguous(),
                             v.contiguous(), params.n_outer, params.n_sor,
                             params.alpha, params.omega, params.eps,
                             params.warp_radius, params.fuse_outer_tol)
    return u, v


def encode_flow_uint8(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) flow image: [U, V, magnitude] channels."""
    uc = torch.clamp(u, -5.0, 5.0)
    vc = torch.clamp(v, -5.0, 5.0)
    mag = torch.sqrt(torch.square(uc / 5.0) + torch.square(vc / 5.0)) / math.sqrt(2.0)
    mag = torch.clamp(mag, 0.0, 1.0)
    f01 = torch.stack([(uc + 5.0) / 10.0, (vc + 5.0) / 10.0, mag], dim=-1)
    return (f01 * 255.0).to(torch.uint8)


def video_flow_uint8(frames: torch.Tensor,
                     params: FlowParams = DEFAULT_PARAMS) -> torch.Tensor:
    """Per-frame flow images for a video (T, H, W, C) -> (T, H, W, 3) uint8.

    Frame t's flow is computed against frame t-1; frame 0 flows against
    itself (zero motion), the reference's first-frame convention
    (chalearn_video_to_flow.py:62-66). All T pairs are solved as one batch."""
    x = frames.float() / 255.0
    prev = torch.cat([x[:1], x[:-1]], dim=0)
    u, v = coarse2fine_flow(prev, x, params)
    return encode_flow_uint8(u, v)
