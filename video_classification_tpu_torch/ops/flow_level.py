"""One pyramid level of the flow solver: CUDA kernel K1 and its plain twin.

``flow_level`` replaces the JAX package's Pallas kernel
``ops/pallas_flow.py::_flow_level_kernel`` (entry ``flow_level_fused_pallas``):
n_outer x (clamped bilinear warp + IRLS data terms + Charbonnier edge weights
+ n_sor red-black SOR sweeps) for a batch of frame pairs, with the per-pair
early exit once an outer's max|du, dv| <= ``outer_tol``. See
``csrc/flow_level.cu`` for the design on Hopper. Its SOR holds each frame on
the chip for a whole outer, one thread-block cluster a pair
(``csrc/sor_resident.cuh``); ``resident_plan`` mirrors that header's plan,
``sor_schedule`` says which schedule a level's SOR takes.

``flow_level_reference`` performs the kernel's float32 operations in the
kernel's order with plain tensor ops, with the fused multiply-adds that
XLA:CPU makes of the Pallas kernel run in interpret mode (``ops/fma.py``)
and a correctly rounded rsqrt for psi and phi. Given XLA:CPU's rsqrt it is
bit-equal to that kernel whenever the kernel's outer loop runs at least two
trips (``n_outer >= 2``: with one, XLA:CPU compiles the body outside the
loop and fuses differently). It is the CPU path and the kernel's oracle on
the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import cuda
from ..utils.profiling import count, span
from .fma import fma_f32, rsqrt_f32
from .sor_solve import (SCHEDULE, _shift_zero, check_tileable,
                        sor_solve_reference, whole_frame)

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# The resident SOR's plan, compiled into csrc/sor_resident.cuh; the wrapper
# passes a level's plan to the binding, which refuses one that differs.
RESIDENT_MAX_CLUSTER = 16   # CTAs per frame, at most
RESIDENT_MAX_SMEM = 232448  # shared memory of one H100 block
RESIDENT_STATIC_SMEM = 16   # the CTA's two mbarriers
RESIDENT_COEFFS = 9         # fields held on the chip
RESIDENT_THREADS = 512      # threads of a CTA
RESIDENT_CELLS = 6          # cells of one colour a thread updates, at most


def resident_smem_bytes(rows: int, w: int) -> int:
    """Shared memory of a CTA holding ``rows`` rows of a w-wide frame: the
    9 fields, wu's row below, (du, dv) with a halo row above and below, each
    split by colour into rows of ceil(w / 2) words."""
    return 2 * ((w + 1) // 2) * (RESIDENT_COEFFS * rows + 1 + 2 * (rows + 2)) * 4


def resident_plan(h: int, w: int) -> Tuple[int, int]:
    """(CTAs per frame, rows per CTA) of the resident SOR at h x w: the
    fewest CTAs, at most ``RESIDENT_MAX_CLUSTER``, whose strips fit one
    CTA's shared memory and its threads' cells; where that is more than 8,
    ``RESIDENT_MAX_CLUSTER`` CTAs' strips (such a cluster holds a GPC
    alone); (0, 0) where none fit."""
    for c in range(1, RESIDENT_MAX_CLUSTER + 1):
        rows = -(-h // c)
        if (resident_smem_bytes(rows, w) + RESIDENT_STATIC_SMEM <= RESIDENT_MAX_SMEM
                and rows * ((w + 1) // 2) <= RESIDENT_CELLS * RESIDENT_THREADS):
            if c > RESIDENT_MAX_CLUSTER // 2:
                rows = -(-h // RESIDENT_MAX_CLUSTER)
            return -(-h // rows), rows
    return 0, 0


def sor_schedule(h: int, w: int) -> str:
    """The schedule of K1's SOR at h x w: "whole" (one block, all
    half-sweeps in one launch; at most 64x64), "resident" (one cluster a
    frame, all half-sweeps in one launch) or "tiled" (the SOR tiles)."""
    if whole_frame(h, w):
        return "whole"
    return "resident" if resident_plan(h, w)[0] else "tiled"


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
    tensors launch the kernel (and raise if it cannot build or launch), and
    count the level as "flow.sor_resident_levels" (a whole or resident
    frame) or "flow.sor_tiled_levels" while a profiler records."""
    _check_inputs(im1, im2, u, v)
    with span("kernel::flow_level"):
        if im1.device.type == "cpu":
            return flow_level_reference(im1, im2, u, v, n_outer, n_sor, alpha,
                                        omega, eps, r_cap, outer_tol)
        check_tileable(*u.shape)
        h, w = u.shape[1:]
        tiled = sor_schedule(h, w) == "tiled"
        count("flow.sor_tiled_levels" if tiled else "flow.sor_resident_levels", 1)
        out = cuda.build().flow_level(im1, im2, u, v, int(n_outer), int(n_sor),
                                      float(alpha), float(omega), float(eps),
                                      int(r_cap), float(outer_tol), SCHEDULE,
                                      list(resident_plan(h, w)))
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


def sum_of_squares(a, b, c, d) -> torch.Tensor:
    """a*a + b*b + c*c + d*d as XLA:CPU computes it (the smoothness
    magnitude): fma(d, d, fma(c, c, fma(a, a, b * b)))."""
    return fma_f32(d, d, fma_f32(c, c, fma_f32(a, a, b * b)))


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
                         outer_tol: float, rsqrt=rsqrt_f32) -> Tensors3:
    """The kernel's arithmetic with plain tensor ops (any device). Every
    multiply-add is fused where XLA:CPU fuses the Pallas kernel's
    (``ops/fma.py``); ``rsqrt`` is the reciprocal square root of psi and phi
    (the tests pass XLA:CPU's)."""
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

        def corner(off):
            return torch.gather(flat2, 1, idx + off).reshape(b, h, w, c)

        # The select-shift warp's sum over the shifts in ascending order, each
        # term fused into the running sum; its only nonzero terms are the
        # four corners.
        warped = corner(0) * (omy * omx)[..., None]
        for off, weight in ((1, omy * wx), (w, wy * omx), (w + 1, wy * wx)):
            warped = fma_f32(corner(off), weight[..., None], warped)

        ix, iy = _grad_xy(0.5 * (im1 + warped), 1, 2)
        it = warped - im1
        psi = rsqrt(fma_f32(it, it, eps))
        # Per channel, a11 += psi*ix * ix, ..., b1 -= psi*ix * it, each fused.
        pxy = psi * torch.stack([ix, ix, iy, -ix, -iy])
        xyt = torch.stack([ix, iy, iy, it, it])
        acc = torch.zeros_like(pxy[..., 0])
        for ch in range(c):
            acc = fma_f32(pxy[..., ch], xyt[..., ch], acc)
        a11, a12, a22, b1, b2 = acc

        ux, uy = _grad_xy(u, 1, 2)
        vx, vy = _grad_xy(v, 1, 2)
        phi = rsqrt(sum_of_squares(ux, uy, vx, vy) + eps)
        du, dv = sor_solve_reference(a11, a12, a22, b1, b2, *_edge_weights(phi),
                                     u, v, n_sor, alpha, omega)

        delta = torch.maximum(du.abs().amax((1, 2)), dv.abs().amax((1, 2)))
        keep = active.view(b, 1, 1)
        mx = torch.where(active, torch.maximum(mx, maxflow), mx)
        u = torch.where(keep, u + du, u)
        v = torch.where(keep, v + dv, v)
        active = active & (delta > outer_tol)
    return u, v, mx
