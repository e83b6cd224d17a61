"""One pyramid level of the flow solver: CUDA kernel K1 and its plain twin.

``flow_level`` replaces the JAX package's Pallas kernel
``ops/pallas_flow.py::_flow_level_kernel`` (entry ``flow_level_fused_pallas``):
n_outer x (clamped bilinear warp + IRLS data terms + Charbonnier edge weights
+ n_sor red-black SOR sweeps) for a batch of frame pairs, with the per-pair
early exit once an outer's max|du, dv| <= ``outer_tol``. See
``csrc/flow_level.cu`` for the design on Hopper.

``flow_level_reference`` performs the kernel's float32 operations in the
kernel's order with plain tensor ops. It is the CPU path and the kernel's
oracle on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import cuda
from .sor_solve import (SCHEDULE, _shift_zero, check_tileable,
                        sor_solve_reference)

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check_inputs(im1, im2, u, v) -> None:
    if im1.dim() != 4 or im1.shape != im2.shape:
        raise ValueError(f"im1/im2 must be (B, H, W, C) alike, got "
                         f"{tuple(im1.shape)} and {tuple(im2.shape)}")
    b, h, w, _ = im1.shape
    if u.shape != (b, h, w) or v.shape != (b, h, w):
        raise ValueError(f"u/v must be {(b, h, w)}, got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"a level needs H, W >= 2, got {(h, w)}")
    for name, t in (("im1", im1), ("im2", im2), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != im1.device:
            raise ValueError(f"{name} is on {t.device}, im1 on {im1.device}")


def flow_level(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor, n_outer: int, n_sor: int, alpha: float,
               omega: float, eps: float, r_cap: int,
               outer_tol: float) -> Tensors3:
    """Refine (u, v) at one level: im* (B, H, W, C) f32, u/v (B, H, W) f32.

    Returns (u, v, mx) with mx (B,) the per-pair max over executed outers of
    the pre-clamp max|flow|. CPU tensors run ``flow_level_reference``; CUDA
    tensors launch the kernel (and raise if it cannot build or launch)."""
    _check_inputs(im1, im2, u, v)
    if im1.device.type == "cpu":
        return flow_level_reference(im1, im2, u, v, n_outer, n_sor, alpha,
                                    omega, eps, r_cap, outer_tol)
    check_tileable(*u.shape)
    out = cuda.build().flow_level(im1, im2, u, v, int(n_outer), int(n_sor),
                                  float(alpha), float(omega), float(eps),
                                  int(r_cap), float(outer_tol), SCHEDULE)
    flow_level.launches += 1
    return out


flow_level.launches = 0


def _grad_xy(f: torch.Tensor, y_dim: int, x_dim: int):
    """Edge-replicated central differences along (y_dim, x_dim)."""
    def diff(dim):
        n = f.shape[dim]
        nxt = torch.cat([f.narrow(dim, 1, n - 1), f.narrow(dim, n - 1, 1)], dim)
        prv = torch.cat([f.narrow(dim, 0, 1), f.narrow(dim, 0, n - 1)], dim)
        return 0.5 * (nxt - prv)

    return diff(x_dim), diff(y_dim)


def _edge_weights(phi: torch.Tensor):
    """(w_up, w_down, w_left, w_right) half-point smoothness weights of phi
    (B, H, W), zero across the border."""
    _, h, w = phi.shape
    rows = torch.arange(h, device=phi.device).view(1, h, 1)
    cols = torch.arange(w, device=phi.device).view(1, 1, w)
    zero = torch.zeros((), device=phi.device)
    return (torch.where(rows == 0, zero, 0.5 * (phi + _shift_zero(phi, 1, 0))),
            torch.where(rows == h - 1, zero, 0.5 * (phi + _shift_zero(phi, -1, 0))),
            torch.where(cols == 0, zero, 0.5 * (phi + _shift_zero(phi, 0, 1))),
            torch.where(cols == w - 1, zero, 0.5 * (phi + _shift_zero(phi, 0, -1))))


def flow_level_reference(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor, n_outer: int, n_sor: int,
                         alpha: float, omega: float, eps: float, r_cap: int,
                         outer_tol: float) -> Tensors3:
    """The kernel's arithmetic with plain tensor ops (any device)."""
    b, h, w, c = im1.shape
    dev = im1.device
    rows = torch.arange(h, device=dev).view(1, h, 1)
    cols = torch.arange(w, device=dev).view(1, 1, w)
    rows_f, cols_f = rows.float(), cols.float()
    flat2 = im2.reshape(b, h * w, c)

    u, v = u.clone(), v.clone()
    mx = torch.zeros((b,), dtype=torch.float32, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    for _ in range(n_outer):
        maxflow = torch.maximum(u.abs().amax((1, 2)), v.abs().amax((1, 2)))
        r = torch.clamp(torch.ceil(maxflow).clamp(max=r_cap).to(torch.int32),
                        min=1).float().view(b, 1, 1)
        ys = torch.clamp(rows_f + torch.minimum(torch.maximum(v, -r), r),
                         0.0, h - 1.0)
        xs = torch.clamp(cols_f + torch.minimum(torch.maximum(u, -r), r),
                         0.0, w - 1.0)
        y0 = torch.floor(ys).to(torch.int64).clamp(max=h - 2)
        x0 = torch.floor(xs).to(torch.int64).clamp(max=w - 2)
        wy = ys - y0.float()
        wx = xs - x0.float()
        omy, omx = 1.0 - wy, 1.0 - wx
        idx = (y0 * w + x0).reshape(b, h * w, 1).expand(b, h * w, c)

        def corner(off, weight):
            g = torch.gather(flat2, 1, idx + off).reshape(b, h, w, c)
            return g * weight[..., None]

        warped = corner(0, omy * omx)
        warped = warped + corner(1, omy * wx)
        warped = warped + corner(w, wy * omx)
        warped = warped + corner(w + 1, wy * wx)

        ix, iy = _grad_xy(0.5 * (im1 + warped), 1, 2)
        it = warped - im1
        psi = 1.0 / torch.sqrt(it * it + eps)
        a11 = a12 = a22 = b1 = b2 = torch.zeros_like(u)
        for ch in range(c):
            p_, x_, y_, t_ = psi[..., ch], ix[..., ch], iy[..., ch], it[..., ch]
            a11 = a11 + p_ * x_ * x_
            a12 = a12 + p_ * x_ * y_
            a22 = a22 + p_ * y_ * y_
            b1 = b1 - p_ * x_ * t_
            b2 = b2 - p_ * y_ * t_

        ux, uy = _grad_xy(u, 1, 2)
        vx, vy = _grad_xy(v, 1, 2)
        mag = ux * ux + uy * uy + vx * vx + vy * vy
        phi = 1.0 / torch.sqrt(mag + eps)
        du, dv = sor_solve_reference(a11, a12, a22, b1, b2, *_edge_weights(phi),
                                     u, v, n_sor, alpha, omega)

        delta = torch.maximum(du.abs().amax((1, 2)), dv.abs().amax((1, 2)))
        keep = active.view(b, 1, 1)
        mx = torch.where(active, torch.maximum(mx, maxflow), mx)
        u = torch.where(keep, u + du, u)
        v = torch.where(keep, v + dv, v)
        active = active & (delta > outer_tol)
    return u, v, mx
