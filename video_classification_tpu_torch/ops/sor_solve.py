"""The per-op flow level's SOR solve: CUDA kernel K4 and its plain twin.

``sor_solve`` replaces the JAX package's Pallas kernel
``ops/pallas_flow.py::_sor_kernel`` (entry ``sor_solve_pallas``): ``n_sor``
red-black SOR sweeps for the increments (du, dv) of the per-pixel 2x2 normal
equations [a11 a12; a12 a22] with the 4-neighbour smoothness term of
half-point weights (wu, wd, wl, wr) on the total flow (u + du, v + dv),
warm-started from (du0, dv0). Red pixels ((r + c) % 2 == 0) go first; each
half-sweep updates du on its colour, then dv with the new du. See
``csrc/sor_solve.cu`` and ``csrc/sor_tiles.cuh`` for the design on Hopper:
the half-sweeps run in on-chip tiles, ``HALF_SWEEPS`` per launch on windows
of at most ``TILE`` (interior plus a halo of ``HALF_SWEEPS`` pixels), or all
in one launch on a frame that fits one window.

``sor_solve_reference`` performs the kernel's float32 operations in the
kernel's order with plain tensor ops, as the JAX package's XLA loop
(``ops/flow.py::_flow_level``) does. It is the CPU path and the kernel's
oracle on the card, and the solve of K1's plain twin
(``ops/flow_level.py``), whose sweeps are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import cuda

FIELDS = ("a11", "a12", "a22", "b1", "b2", "wu", "wd", "wl", "wr", "u", "v",
          "du0", "dv0")

# The SOR tiles' schedule, compiled into csrc/sor_tiles.cuh; the wrappers of
# K4 and K1 pass it to the bindings, which refuse numbers that differ. A
# frame of at most TILE is one tile with no halo (the whole-frame mode).
TILE = (64, 64)   # a window's rows and columns, halo included
HALF_SWEEPS = 12  # half-sweeps per tiled launch, and the halo
SCHEDULE = (*TILE, HALF_SWEEPS)


def whole_frame(h: int, w: int) -> bool:
    """Whether an h x w frame runs as one tile, all half-sweeps at once."""
    return h <= TILE[0] and w <= TILE[1]


def check_tileable(b: int, h: int, w: int) -> None:
    """Raise unless the kernels' tiles cover a (b, h, w) batch: an empty
    batch or frame has none."""
    if not (b >= 1 and h >= 1 and w >= 1):
        raise ValueError(f"the SOR tiles cannot cover a {(b, h, w)} batch: "
                         "need B, H, W >= 1")


def _check_inputs(fields) -> None:
    shape, dev = fields[0].shape, fields[0].device
    if len(shape) != 3:
        raise ValueError(f"a11 must be (B, H, W), got {tuple(shape)}")
    for name, t in zip(FIELDS, fields):
        if t.shape != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, a11 {tuple(shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a11 on {dev}")


def sor_solve(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v, n_sor: int,
              alpha: float, omega: float, du0: Optional[torch.Tensor] = None,
              dv0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(du, dv), each (B, H, W) f32, from 11 (B, H, W) f32 fields and the
    warm start (zeros when None). CPU tensors run ``sor_solve_reference``;
    CUDA tensors launch the kernel (and raise if it cannot build or
    launch)."""
    if du0 is None:
        du0 = torch.zeros_like(a11)
    if dv0 is None:
        dv0 = torch.zeros_like(a11)
    fields = (a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v, du0, dv0)
    _check_inputs(fields)
    if a11.device.type == "cpu":
        return sor_solve_reference(*fields[:11], n_sor, alpha, omega,
                                   du0, dv0)
    check_tileable(*a11.shape)
    du, dv = cuda.build().sor_solve(*fields, int(n_sor), float(alpha),
                                    float(omega), SCHEDULE)
    sor_solve.launches += 1
    return du, dv


sor_solve.launches = 0


def _shift_zero(f: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = f[y - dy, x - dx] over (B, H, W), zero outside."""
    out = torch.zeros_like(f)
    h, w = f.shape[1:]
    out[:, max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] = \
        f[:, max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)]
    return out


def _neighbour(f, wu, wd, wl, wr):
    """sum_q w_pq * f_q over the 4-neighbourhood, zero outside."""
    return (wu * _shift_zero(f, 1, 0) + wd * _shift_zero(f, -1, 0)
            + wl * _shift_zero(f, 0, 1) + wr * _shift_zero(f, 0, -1))


def sor_solve_reference(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v,
                        n_sor: int, alpha: float, omega: float,
                        du0: Optional[torch.Tensor] = None,
                        dv0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic with plain tensor ops (any device)."""
    _, h, w = a11.shape
    dev = a11.device
    rows = torch.arange(h, device=dev).view(1, h, 1)
    cols = torch.arange(w, device=dev).view(1, 1, w)
    red = (rows + cols) % 2 == 0
    # Hoisted out of the sweeps, as in the JAX package: the reciprocal
    # diagonals and the constant total-flow part of the smoothness term.
    wsum = wu + wd + wl + wr
    inv_u = 1.0 / (a11 + alpha * wsum)
    inv_v = 1.0 / (a22 + alpha * wsum)
    nu_const = _neighbour(u, wu, wd, wl, wr) - wsum * u
    nv_const = _neighbour(v, wu, wd, wl, wr) - wsum * v

    du = torch.zeros_like(a11) if du0 is None else du0.clone()
    dv = torch.zeros_like(a11) if dv0 is None else dv0.clone()
    for _ in range(n_sor):
        for mask in (red, ~red):
            su = nu_const + _neighbour(du, wu, wd, wl, wr)
            new_du = (b1 - a12 * dv + alpha * su) * inv_u
            du = torch.where(mask, (1 - omega) * du + omega * new_du, du)
            sv = nv_const + _neighbour(dv, wu, wd, wl, wr)
            new_dv = (b2 - a12 * du + alpha * sv) * inv_v
            dv = torch.where(mask, (1 - omega) * dv + omega * new_dv, dv)
    return du, dv
