"""The per-op flow level's IRLS coefficients: a CUDA kernel and its plain twin.

``irls_coefficients`` computes one inner's normal equations of the per-op
level (``ops/flow.py::_flow_level_per_op``) in one launch: the data terms of
the outer (the mean of both images' gradients, the temporal difference), the
robust data weight psi at the increments (du, dv), the five channel sums,
the Charbonnier smoothness weight phi of the total flow (u + du, v + dv) and
its half-point edge weights. It has no Pallas counterpart: on the TPU it is
XLA's fusion of the JAX package's ``ops/flow.py::_flow_level``. See
``csrc/irls.cu`` for the kernel.

``irls_coefficients_reference`` (``data_terms``, then ``_normal_equations``)
performs the kernel's float32 operations in its order with plain tensor ops,
every multiply-add fused where XLA:CPU fuses the JAX package's
(``ops/fma.py``), and is the CPU path and the kernel's oracle on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import cuda
from ..utils.profiling import span
from .flow_level import _edge_weights, _grad_xy, sum_of_squares
from .fma import fma_f32, rsqrt_f32

FIELDS = ("a11", "a12", "a22", "b1", "b2", "wu", "wd", "wl", "wr")


def data_terms(im1: torch.Tensor, warped: torch.Tensor,
               warped_grad: torch.Tensor):
    """(ix, iy, it), each (B, H, W, C): the mean of im1's and warped_grad's
    gradients, and warped - im1."""
    ix1, iy1 = _grad_xy(im1, 1, 2)
    ix2, iy2 = _grad_xy(warped_grad, 1, 2)
    return 0.5 * (ix1 + ix2), 0.5 * (iy1 + iy2), warped - im1


def channel_dot(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum over the last dim of p * x * y as XLA:CPU reduces it: from 0, each
    channel's (p * x) * y fused into the running sum (x and y may stack
    several pairs in front of p's dims)."""
    px = p * x
    out = torch.zeros_like(px[..., 0])
    for ch in range(p.shape[-1]):
        out = fma_f32(px[..., ch], y[..., ch], out)
    return out


def _normal_equations(ix, iy, it, u, v, du, dv, eps: float, rsqrt=rsqrt_f32):
    """(a11, a12, a22, b1, b2, wu, wd, wl, wr), each (B, H, W), of one inner:
    the IRLS data terms at the increments (du, dv) and the Charbonnier edge
    weights of the total flow (u + du, v + dv). Every multiply-add is fused
    where XLA:CPU fuses the JAX package's (``ops/fma.py``); ``rsqrt`` is the
    reciprocal square root of psi and phi (the tests pass XLA:CPU's)."""
    rho = fma_f32(iy, dv[..., None], fma_f32(ix, du[..., None], it))
    psi = rsqrt(fma_f32(rho, rho, eps))
    ux, uy = _grad_xy(u + du, 1, 2)
    vx, vy = _grad_xy(v + dv, 1, 2)
    phi = rsqrt(sum_of_squares(ux, uy, vx, vy) + eps)
    a11, a12, a22, nb1, nb2 = channel_dot(psi, torch.stack([ix, ix, iy, ix, iy]),
                                          torch.stack([ix, iy, iy, it, it]))
    return (a11, a12, a22, -nb1, -nb2) + _edge_weights(phi)


def irls_coefficients_reference(im1, warped, warped_grad, u, v, du, dv,
                                eps: float, rsqrt=rsqrt_f32):
    """The kernel's arithmetic with plain tensor ops (any device)."""
    return _normal_equations(*data_terms(im1, warped, warped_grad), u, v, du,
                             dv, eps, rsqrt)


def _check_inputs(im1, warped, warped_grad, u, v, du, dv) -> None:
    if im1.dim() != 4:
        raise ValueError(f"im1 must be (B, H, W, C), got {tuple(im1.shape)}")
    b, h, w, _ = im1.shape
    images = (("im1", im1), ("warped", warped), ("warped_grad", warped_grad))
    flows = (("u", u), ("v", v), ("du", du), ("dv", dv))
    for name, t in images:
        if t.shape != im1.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, im1 {tuple(im1.shape)}")
    for name, t in flows:
        if t.shape != (b, h, w):
            raise ValueError(f"{name} must be {(b, h, w)}, got {tuple(t.shape)}")
    for name, t in images + flows:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != im1.device:
            raise ValueError(f"{name} is on {t.device}, im1 on {im1.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def irls_coefficients(im1: torch.Tensor, warped: torch.Tensor,
                      warped_grad: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor, du: torch.Tensor, dv: torch.Tensor,
                      eps: float, rsqrt=rsqrt_f32) -> Tuple[torch.Tensor, ...]:
    """(a11, a12, a22, b1, b2, wu, wd, wl, wr), each (B, H, W) f32, of one
    inner: im1, warped and warped_grad (B, H, W, C) f32, the flow (u, v) and
    the increments (du, dv) (B, H, W) f32, all contiguous. warped_grad is the
    warp the gradients take: warped itself with one inner, K5's other order
    with several (``ops/flow.py::_warps``). CPU tensors run
    ``irls_coefficients_reference`` (with ``rsqrt``, which the tests set to
    XLA:CPU's); CUDA tensors launch the kernel, which computes the correctly
    rounded rsqrt only, and raise if it cannot build or launch."""
    _check_inputs(im1, warped, warped_grad, u, v, du, dv)
    with span("kernel::irls_coefficients"):
        if im1.device.type == "cpu":
            return irls_coefficients_reference(im1, warped, warped_grad, u, v, du,
                                               dv, eps, rsqrt)
        if rsqrt is not rsqrt_f32:
            raise ValueError("the IRLS kernel computes the correctly rounded rsqrt "
                             "(rsqrt_f32) only")
        out = cuda.build().irls_coefficients(im1, warped, warped_grad, u, v, du,
                                             dv, float(eps))
    irls_coefficients.launches += 1
    return tuple(out.unbind(0))


irls_coefficients.launches = 0
