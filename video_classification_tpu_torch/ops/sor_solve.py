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
(``ops/flow.py::_flow_level``) does, with XLA:CPU's fused multiply-adds
(``ops/fma.py``) in its places: ``weighted_sum``, ``hoisted`` and ``relax``.
From the same coefficients it is bit-equal to that loop at every level
shape, and to the Pallas kernel run in interpret mode when all its sweeps
run inside its loop (an even ``n_sor`` of at least 4: XLA:CPU compiles the
remainder sweep, and a loop of one trip, outside the loop and fuses dv's
update there differently). It is the CPU path and the kernel's oracle on
the card, and the solve of K1's plain twin (``ops/flow_level.py``), whose
sweeps are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import cuda
from ..utils.profiling import span
from .fma import fma_f32

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
    with span("kernel::sor_solve"):
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


def weighted_sum(wu, wd, wl, wr, up, dn, lf, rt):
    """wu*up + wd*dn + wl*lf + wr*rt as XLA:CPU computes it: left to right,
    each product after the first fused into the running sum
    (``fma(wr, rt, fma(wl, lf, fma(wu, up, wd * dn)))``)."""
    return fma_f32(wr, rt, fma_f32(wl, lf, fma_f32(wu, up, wd * dn)))


def _neighbour(f, wu, wd, wl, wr):
    """sum_q w_pq * f_q over the 4-neighbourhood, zero outside."""
    return weighted_sum(wu, wd, wl, wr, _shift_zero(f, 1, 0),
                        _shift_zero(f, -1, 0), _shift_zero(f, 0, 1),
                        _shift_zero(f, 0, -1))


def hoisted(a11, a22, wu, wd, wl, wr, u, v, alpha: float):
    """(inv_u, inv_v, nu_const, nv_const), hoisted out of the sweeps as in
    the JAX package: the reciprocal diagonals 1 / (a + alpha * wsum) and the
    constant total-flow part of the smoothness term, neighbour(u) - wsum * u,
    each multiply-add fused where XLA:CPU fuses it."""
    wsum = wu + wd + wl + wr
    return (1.0 / fma_f32(alpha, wsum, a11), 1.0 / fma_f32(alpha, wsum, a22),
            fma_f32(-wsum, u, _neighbour(u, wu, wd, wl, wr)),
            fma_f32(-wsum, v, _neighbour(v, wu, wd, wl, wr)))


def relax(d, d_other, b, a12, s, inv, alpha: float, omega: float):
    """One increment's over-relaxed update, (1 - omega) * d + omega * new
    with new = (b - a12 * d_other + alpha * s) * inv, fused as XLA:CPU
    fuses it: new = fma(alpha, s, fma(-a12, d_other, b)) * inv, then
    fma(omega, new, (1 - omega) * d)."""
    new = fma_f32(alpha, s, fma_f32(-a12, d_other, b)) * inv
    return fma_f32(omega, new, (1 - omega) * d)


def _colours(b: int, h: int, w: int, device):
    """Red ((y + x) % 2 == 0), then black: for each, the flat indices of its
    pixels in a (B, H, W) field and of their up, down, left and right
    neighbours, where index B*H*W stands for a neighbour outside the frame."""
    n = b * h * w
    flat = torch.arange(n, device=device).view(b, h, w)
    y = torch.arange(h, device=device).view(1, h, 1)
    x = torch.arange(w, device=device).view(1, 1, w)
    nbrs = (torch.where(y > 0, flat - w, n), torch.where(y < h - 1, flat + w, n),
            torch.where(x > 0, flat - 1, n), torch.where(x < w - 1, flat + 1, n))
    red = ((y + x) % 2 == 0).expand(b, h, w)
    return [(flat[m], [f[m] for f in nbrs]) for m in (red, ~red)]


def sor_solve_reference(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v,
                        n_sor: int, alpha: float, omega: float,
                        du0: Optional[torch.Tensor] = None,
                        dv0: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic with plain tensor ops (any device). A
    half-sweep computes only its colour's pixels: (du, dv) are kept flat
    with a trailing 0 for the neighbours outside the frame."""
    b, h, w = a11.shape
    inv_u, inv_v, nu_const, nv_const = hoisted(a11, a22, wu, wd, wl, wr, u, v,
                                               alpha)
    start = [a11.new_zeros(a11.shape) if d is None else d for d in (du0, dv0)]
    du, dv = (torch.cat([d.flatten(), a11.new_zeros(1)]) for d in start)
    colours = []
    for pix, nbrs in _colours(b, h, w, a11.device):
        cwu, cwd, cwl, cwr, ca12, cb1, cb2, ciu, civ, cnu, cnv = (
            f.flatten()[pix] for f in (wu, wd, wl, wr, a12, b1, b2, inv_u,
                                       inv_v, nu_const, nv_const))
        # The fields that only fma_f32 multiplies or adds go to float64 once
        # (exactly) rather than in every call; wd stays float32 for the
        # product wd * dn, rounded before the first fused add.
        colours.append((pix, nbrs, (cwu.double(), cwd, cwl.double(),
                                    cwr.double(), ca12.double(), cb1.double(),
                                    cb2.double(), ciu, civ, cnu, cnv)))
    # index_select / index_copy_ move the same values as du[i] / du[i] = x,
    # at a third of the cost on the CPU.
    for _ in range(n_sor):
        for pix, nbrs, (cwu, cwd, cwl, cwr, ca12, cb1, cb2, ciu, civ, cnu,
                        cnv) in colours:
            su = cnu + weighted_sum(cwu, cwd, cwl, cwr,
                                    *(du.index_select(0, i) for i in nbrs))
            du_new = relax(du.index_select(0, pix), dv.index_select(0, pix), cb1,
                           ca12, su, ciu, alpha, omega)
            du.index_copy_(0, pix, du_new)
            sv = cnv + weighted_sum(cwu, cwd, cwl, cwr,
                                    *(dv.index_select(0, i) for i in nbrs))
            dv.index_copy_(0, pix, relax(dv.index_select(0, pix), du_new, cb2, ca12,
                                         sv, civ, alpha, omega))
    return du[:-1].view(b, h, w), dv[:-1].view(b, h, w)
