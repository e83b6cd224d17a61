"""Plain float32 coarse-to-fine variational optical flow (reference copy).

The flow the serving path computes on its fused level (the JAX package's
``flow_level_fused_pallas`` semantics, which the program's kernel K1
implements): a Gaussian pyramid with ratio 0.75 down to a width of 20,
``jax.image.resize``-style linear resizes (antialiased when downsampling),
and per level ``n_outer`` relinearisations, each

  * a bilinear warp of the second image by the flow clamped to +-``r`` px
    (r = ceil(max |flow|) of the pair, capped at ``warp_radius``, at least 1);
  * the gradients of the mean of the first and the warped image, the
    temporal difference ``it``, and the Charbonnier weights
    psi = 1 / sqrt(it^2 + eps) (data) and phi = 1 / sqrt(|grad u|^2 +
    |grad v|^2 + eps) (smoothness, half-point edge weights);
  * ``n_sor`` red-black SOR sweeps of the 2x2 normal equations with the
    4-neighbour smoothness term;
  * the pair stops refining the level after an outer that moved it by at
    most ``outer_tol`` px.

Every operation is a plain float32 tensor op (a multiply and an add are two
roundings; the program fuses some into one), so this and the program agree
to float32 rounding, not bit for bit. ``encode_flow_uint8`` is the on-disk
encoding of the ChaLearn reference (chalearn_video_to_flow.py).

``quant`` (default ``F32``, none) rounds every tensor the solver keeps (the pyramid,
the warped image, its gradients, the IRLS coefficients and weights, each
SOR half-sweep's increment, the flow) on its way out of the operation that
made it: ``BF16`` gives the control's flow held in bfloat16.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def F32(t: torch.Tensor) -> torch.Tensor:
    """Keep a float32 tensor as it is."""
    return t


def BF16(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to bfloat16 and back."""
    return t.to(torch.bfloat16).float()


class FlowParams(NamedTuple):
    alpha: float = 0.012
    ratio: float = 0.75
    min_width: int = 20
    n_outer: int = 7
    n_sor: int = 30
    omega: float = 1.8
    eps: float = 1e-6
    warp_radius: int = 8
    outer_tol: float = 0.005


def pyramid_shapes(h: int, w: int, ratio: float, min_width: int) -> List[Tuple[int, int]]:
    shapes = [(h, w)]
    while True:
        nh, nw = int(round(shapes[-1][0] * ratio)), int(round(shapes[-1][1] * ratio))
        if min(nh, nw) < min_width:
            return shapes
        shapes.append((nh, nw))


def _edge_pad(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1).expand(*[r if d == dim else -1 for d in range(x.dim())])
    last = x.narrow(dim, n - 1, 1).expand(*[r if d == dim else -1 for d in range(x.dim())])
    return torch.cat([first, x, last], dim)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of radius ceil(2 sigma) over (B, H, W, C),
    edge-replicated."""
    radius = max(1, int(math.ceil(2.0 * sigma)))
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    k = torch.exp(-0.5 * (offsets / sigma) ** 2)
    k = k / k.sum()

    def axis(v, dim):
        vp = _edge_pad(v, dim, radius)
        out = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            out = out + k[i] * vp.narrow(dim, i, v.shape[dim])
        return out

    return axis(axis(x, 1), 2)


def resize_matrix(m: int, n: int, device) -> torch.Tensor:
    """(n, m) float32 weights of ``jax.image.resize(..., "linear")`` along
    one axis: the triangle kernel widened by max(m / n, 1), each row
    normalized, zero where the sample falls outside [-0.5, m - 0.5]."""
    scale = m / n
    width = max(scale, 1.0)
    sample = (np.arange(n) + 0.5) * scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(m)[None, :])
    w = np.maximum(1.0 - dist / width, 0.0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    w[(sample < -0.5) | (sample > m - 0.5)] = 0.0
    return torch.from_numpy(w.astype(np.float32)).to(device)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), H then W."""
    b, h, w, c = x.shape
    if h != hw[0]:
        x = torch.einsum("oh,bhwc->bowc", resize_matrix(h, hw[0], x.device), x)
    if w != hw[1]:
        x = torch.einsum("ow,bhwc->bhoc", resize_matrix(w, hw[1], x.device), x)
    return x.contiguous()


def _grad_xy(f: torch.Tensor, y_dim: int, x_dim: int):
    """Edge-replicated central differences (d/dx, d/dy)."""
    def diff(dim):
        n = f.shape[dim]
        nxt = torch.cat([f.narrow(dim, 1, n - 1), f.narrow(dim, n - 1, 1)], dim)
        prv = torch.cat([f.narrow(dim, 0, 1), f.narrow(dim, 0, n - 1)], dim)
        return 0.5 * (nxt - prv)

    return diff(x_dim), diff(y_dim)


def _shift(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = f[y - dy, x - dx] over (B, H, W), zero outside."""
    out = torch.zeros_like(f)
    h, w = f.shape[1:]
    out[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        f[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def _edge_weights(phi: torch.Tensor):
    """Half-point smoothness weights (up, down, left, right), zero across
    the border."""
    _, h, w = phi.shape
    rows = torch.arange(h, device=phi.device).view(1, h, 1)
    cols = torch.arange(w, device=phi.device).view(1, 1, w)
    zero = torch.zeros((), device=phi.device)
    return (torch.where(rows == 0, zero, 0.5 * (phi + _shift(phi, 1, 0))),
            torch.where(rows == h - 1, zero, 0.5 * (phi + _shift(phi, -1, 0))),
            torch.where(cols == 0, zero, 0.5 * (phi + _shift(phi, 0, 1))),
            torch.where(cols == w - 1, zero, 0.5 * (phi + _shift(phi, 0, -1))))


def _neighbours(f, wu, wd, wl, wr):
    """wu * f[y-1] + wd * f[y+1] + wl * f[x-1] + wr * f[x+1], zero outside."""
    p = F.pad(f, (1, 1, 1, 1))
    return (wu * p[:, :-2, 1:-1] + wd * p[:, 2:, 1:-1] + wl * p[:, 1:-1, :-2]
            + wr * p[:, 1:-1, 2:])


def sor(a11, a12, a22, b1, b2, weights, u, v, n_sor: int, alpha: float,
        omega: float, q=F32):
    """(du, dv) after ``n_sor`` red-black SOR sweeps from zero: red pixels
    ((y + x) even) first; in each half-sweep du on that colour, then dv with
    the new du."""
    wu, wd, wl, wr = weights
    _, h, w = a11.shape
    wsum = q(wu + wd + wl + wr)
    inv_u = q(1.0 / (a11 + alpha * wsum))
    inv_v = q(1.0 / (a22 + alpha * wsum))
    nu = q(_neighbours(u, wu, wd, wl, wr) - wsum * u)
    nv = q(_neighbours(v, wu, wd, wl, wr) - wsum * v)
    y = torch.arange(h, device=a11.device).view(1, h, 1)
    x = torch.arange(w, device=a11.device).view(1, 1, w)
    red = (y + x) % 2 == 0
    du = torch.zeros_like(a11)
    dv = torch.zeros_like(a11)
    for _ in range(n_sor):
        for colour in (red, ~red):
            su = nu + _neighbours(du, wu, wd, wl, wr)
            new = (b1 - a12 * dv + alpha * su) * inv_u
            du = torch.where(colour, q((1 - omega) * du + omega * new), du)
            sv = nv + _neighbours(dv, wu, wd, wl, wr)
            new = (b2 - a12 * du + alpha * sv) * inv_v
            dv = torch.where(colour, q((1 - omega) * dv + omega * new), dv)
    return du, dv


def flow_level(im1, im2, u, v, p: FlowParams, q=F32):
    """Refine (u, v) (B, H, W) at one level of images (B, H, W, C)."""
    b, h, w, c = im1.shape
    dev = im1.device
    rows = torch.arange(h, device=dev).view(1, h, 1).float()
    cols = torch.arange(w, device=dev).view(1, 1, w).float()
    flat2 = im2.reshape(b, h * w, c)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    for _ in range(p.n_outer):
        maxflow = torch.maximum(u.abs().amax((1, 2)), v.abs().amax((1, 2)))
        r = torch.clamp(torch.ceil(maxflow).clamp(max=p.warp_radius), min=1).view(b, 1, 1)
        ys = torch.clamp(rows + torch.minimum(torch.maximum(v, -r), r), 0.0, h - 1.0)
        xs = torch.clamp(cols + torch.minimum(torch.maximum(u, -r), r), 0.0, w - 1.0)
        y0 = torch.floor(ys).long().clamp(max=h - 2)
        x0 = torch.floor(xs).long().clamp(max=w - 2)
        wy, wx = ys - y0.float(), xs - x0.float()
        idx = (y0 * w + x0).reshape(b, h * w, 1).expand(b, h * w, c)

        def corner(off):
            return torch.gather(flat2, 1, idx + off).reshape(b, h, w, c)

        warped = q(corner(0) * ((1 - wy) * (1 - wx))[..., None]
                  + corner(1) * ((1 - wy) * wx)[..., None]
                  + corner(w) * (wy * (1 - wx))[..., None]
                  + corner(w + 1) * (wy * wx)[..., None])
        ix, iy = map(q, _grad_xy(0.5 * (im1 + warped), 1, 2))
        it = q(warped - im1)
        psi = q(torch.rsqrt(it * it + p.eps))
        a11 = q((psi * ix * ix).sum(-1))
        a12 = q((psi * ix * iy).sum(-1))
        a22 = q((psi * iy * iy).sum(-1))
        b1 = q(-(psi * ix * it).sum(-1))
        b2 = q(-(psi * iy * it).sum(-1))
        ux, uy = _grad_xy(u, 1, 2)
        vx, vy = _grad_xy(v, 1, 2)
        phi = q(torch.rsqrt(ux * ux + uy * uy + vx * vx + vy * vy + p.eps))
        du, dv = sor(a11, a12, a22, b1, b2, tuple(map(q, _edge_weights(phi))), u, v, p.n_sor,
                     p.alpha, p.omega, q)
        delta = torch.maximum(du.abs().amax((1, 2)), dv.abs().amax((1, 2)))
        keep = active.view(b, 1, 1)
        u = torch.where(keep, q(u + du), u)
        v = torch.where(keep, q(v + dv), v)
        active = active & (delta > p.outer_tol)
    return u, v


def coarse2fine(im1: torch.Tensor, im2: torch.Tensor, p: FlowParams = FlowParams(), q=F32):
    """(u, v), each (B, H, W), of pairs of (B, H, W, C) images in [0, 1]."""
    b, h, w, _ = im1.shape
    shapes = pyramid_shapes(h, w, p.ratio, p.min_width)
    sigma = (1.0 / p.ratio - 1.0) + 0.3
    pyr = [q(torch.cat([im1, im2]).float())]
    for hw in shapes[1:]:
        pyr.append(q(resize_bilinear(gaussian_blur(pyr[-1], sigma), hw)))
    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=torch.float32, device=im1.device)
    v = torch.zeros_like(u)
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if u.shape[1:] != (th, tw):
            sx, sy = tw / u.shape[2], th / u.shape[1]
            uv = resize_bilinear(torch.stack([u, v], -1), (th, tw))
            u, v = q(uv[..., 0] * sx), q(uv[..., 1] * sy)
        u, v = flow_level(pyr[lvl][:b], pyr[lvl][b:], u.contiguous(), v.contiguous(), p, q)
    return u, v


def encode_flow_uint8(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8: U, V clipped to +-5 px and mapped to [0, 1], and
    the magnitude, all x255 and truncated."""
    uc, vc = torch.clamp(u, -5.0, 5.0), torch.clamp(v, -5.0, 5.0)
    mag = torch.sqrt(torch.square(uc / 5.0) + torch.square(vc / 5.0)) / math.sqrt(2.0)
    f01 = torch.stack([(uc + 5.0) / 10.0, (vc + 5.0) / 10.0, torch.clamp(mag, 0.0, 1.0)], -1)
    return (f01 * 255.0).to(torch.uint8)


def pair_flows(frames: torch.Tensor, pairs: torch.Tensor, p: FlowParams = FlowParams(),
               chunk: int = 256, quant=F32) -> torch.Tensor:
    """uint8 flow images (K, H, W, 3) of the frame pairs ``pairs`` (K, 2)
    (index of the first, of the second frame) of ``frames`` (T, H, W, 3)
    uint8, solved ``chunk`` pairs at a time, each kept tensor rounded by
    ``quant``."""
    out = []
    for start in range(0, pairs.shape[0], chunk):
        pr = pairs[start:start + chunk].to(frames.device)
        im1 = frames[pr[:, 0]].float() / 255.0
        im2 = frames[pr[:, 1]].float() / 255.0
        out.append(encode_flow_uint8(*coarse2fine(im1, im2, p, quant)))
    return torch.cat(out)
