"""Coarse-to-fine variational optical flow, batched over frame pairs.

Port of the JAX package's ``ops/flow.py``: a Gaussian pyramid with downsample
``ratio`` (0.75) down to ``min_width`` (20), and per level ``n_outer``
relinearisations, each a bilinear warp, IRLS data and smoothness weights and
``n_sor`` red-black SOR sweeps; flow upsampled between levels. A level runs
one of two paths, as in the JAX package:

  * the fused level (``ops/flow_level.py``, kernel K1 on the card), the
    semantics of the JAX package's fused Pallas kernel: merged gradients, a
    warp clamped to +-``warp_radius`` px, a per-pair early exit after an
    outer that moves the pair by <= ``fuse_outer_tol``. Taken when
    ``n_inner == 1`` and ``fuse_level`` is "auto" or "on";
  * the per-op level (``_flow_level_per_op``), the JAX package's XLA path,
    which made the checked-in flow goldens: per-image gradients averaged, an
    unclamped warp (kernel K5, ``ops/warp.py``), every outer run, and
    ``n_inner`` IRLS solves per outer, each warm-started from the previous
    one (kernel K4, ``ops/sor_solve.py``). Taken when ``fuse_level`` is
    "off" or ``n_inner != 1``.

The JAX package's ``backend``, ``warp``, ``warp_tiers``, ``fuse_stack`` and
``fuse_warp_radius`` choose between TPU routes and have no counterpart here:
a CUDA tensor always launches the port's kernels and a CPU tensor always runs
their plain versions.

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

from .flow_level import _edge_weights, _grad_xy, flow_level
from .sor_solve import sor_solve
from .warp import warp_bilinear


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
    # "auto" / "on": the fused level (K1) when n_inner == 1; "off": the
    # per-op level. warp_radius and fuse_outer_tol act on the fused level
    # only.
    fuse_level: str = "auto"


DEFAULT_PARAMS = FlowParams()
FUSE_LEVELS = ("auto", "on", "off")


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


def _use_fused_level(p: FlowParams) -> bool:
    if p.fuse_level not in FUSE_LEVELS:
        raise ValueError(f"fuse_level must be one of {FUSE_LEVELS}, got "
                         f"{p.fuse_level!r}")
    return p.n_inner == 1 and p.fuse_level != "off"


def _channel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right (the same order on every
    device)."""
    out = x[..., 0]
    for ch in range(1, x.shape[-1]):
        out = out + x[..., ch]
    return out


def _outer_terms(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor):
    """(ix, iy, it), each (B, H, W, C), of one outer: im2 warped by (u, v)
    (K5), the mean of both images' gradients, the temporal difference."""
    warped = warp_bilinear(im2, u, v)
    ix1, iy1 = _grad_xy(im1, 1, 2)
    ix2, iy2 = _grad_xy(warped, 1, 2)
    return 0.5 * (ix1 + ix2), 0.5 * (iy1 + iy2), warped - im1


def _normal_equations(ix, iy, it, u, v, du, dv, eps: float):
    """(a11, a12, a22, b1, b2, wu, wd, wl, wr), each (B, H, W), of one inner:
    the IRLS data terms at the increments (du, dv) and the Charbonnier edge
    weights of the total flow (u + du, v + dv)."""
    rho = it + ix * du[..., None] + iy * dv[..., None]
    psi = 1.0 / torch.sqrt(rho * rho + eps)
    a11 = _channel_sum(psi * ix * ix)
    a12 = _channel_sum(psi * ix * iy)
    a22 = _channel_sum(psi * iy * iy)
    b1 = -_channel_sum(psi * ix * it)
    b2 = -_channel_sum(psi * iy * it)
    ux, uy = _grad_xy(u + du, 1, 2)
    vx, vy = _grad_xy(v + dv, 1, 2)
    mag = ux * ux + uy * uy + vx * vx + vy * vy
    phi = 1.0 / torch.sqrt(mag + eps)
    return (a11, a12, a22, b1, b2) + _edge_weights(phi)


def _flow_level_per_op(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor, p: FlowParams):
    """Refine (u, v) at one level along the JAX package's XLA path
    (``ops/flow.py::_flow_level``): per outer one warp (K5) and ``n_inner``
    warm-started solves (K4); every outer runs."""
    for _outer in range(p.n_outer):
        ix, iy, it = _outer_terms(im1, im2, u, v)
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _inner in range(p.n_inner):
            coeffs = _normal_equations(ix, iy, it, u, v, du, dv, p.eps)
            du, dv = sor_solve(*coeffs, u, v, p.n_sor, p.alpha, p.omega,
                               du, dv)
        u = u + du
        v = v + dv
    return u, v


def coarse2fine_flow(im1: torch.Tensor, im2: torch.Tensor,
                     params: FlowParams = DEFAULT_PARAMS):
    """Dense flow for a batch of frame pairs.

    im1, im2: (B, H, W, C) in [0, 1]. Returns (u, v), each (B, H, W) float32,
    in pixels."""
    fused = _use_fused_level(params)
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
        u, v = u.contiguous(), v.contiguous()
        if fused:
            u, v, _ = flow_level(pyr1[lvl], pyr2[lvl], u, v, params.n_outer,
                                 params.n_sor, params.alpha, params.omega,
                                 params.eps, params.warp_radius,
                                 params.fuse_outer_tol)
        else:
            u, v = _flow_level_per_op(pyr1[lvl], pyr2[lvl], u, v, params)
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


def flow_energy_filter(flow_images: torch.Tensor, keep_fraction: float = 0.3,
                       min_keep: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-energy frames of (T, H, W, 3) flow images
    (chalearn_filter_img_by_flow.py:43-66, as the JAX package reads it).

    energy = mean of the magnitude channel. Keeps min(T, max(min_keep,
    int(T * keep_fraction))) frames. Returns (kept indices sorted ascending,
    energies (T,) float32). Among equal energies the lower index is kept
    first, ``jax.lax.top_k``'s order, which ``torch.topk`` does not promise:
    hence a stable descending sort."""
    t = flow_images.shape[0]
    num_keep = min(t, max(min_keep, int(t * keep_fraction)))
    energy = flow_images[..., 2].float().mean(dim=(1, 2))
    order = torch.sort(energy, descending=True, stable=True).indices
    return torch.sort(order[:num_keep]).values, energy
