"""Bilinear warp of a batch of images by dense flows: CUDA kernel K5 and its
plain twin.

``warp_bilinear`` replaces the JAX package's Pallas kernel
``ops/pallas_flow.py::_warp_kernel`` / ``_warp_kernel_loop`` (entry
``warp_select_shift_pallas``) together with the radius cascade and the gather
fallback around it (``ops/flow.py::_warp``): it samples im at (x + u, y + v),
clamped to the border, for every flow, with no radius. See ``csrc/warp.cu``
for the design on Hopper.

``warp_bilinear_reference`` is the JAX package's ``_warp_bilinear`` with the
same float32 operations in the same order, its multiply-adds fused where
XLA:CPU fuses them (``bilinear_sum``): the CPU path and the kernel's oracle
on the card.
"""

from __future__ import annotations

import torch

from ..utils import cuda
from ..utils.profiling import span
from .fma import fma_f32


def _check_inputs(im, u, v) -> None:
    if im.dim() != 4:
        raise ValueError(f"im must be (B, H, W, C), got {tuple(im.shape)}")
    b, h, w, _ = im.shape
    if u.shape != (b, h, w) or v.shape != (b, h, w):
        raise ValueError(f"u/v must be {(b, h, w)}, got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if h < 2 or w < 2:
        raise ValueError(f"the warp needs H, W >= 2, got {(h, w)}")
    for name, t in (("im", im), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != im.device:
            raise ValueError(f"{name} is on {t.device}, im on {im.device}")


def warp_bilinear(im: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  both_orders: bool = False):
    """im (B, H, W, C) f32 sampled at (x + u, y + v), clamped to the border;
    u, v (B, H, W) f32. With ``both_orders`` also the same warp with the
    other order of XLA:CPU's first fused multiply-add (``bilinear_sum``), as
    a pair (warped, warped_right). CPU tensors run
    ``warp_bilinear_reference``; CUDA tensors launch the kernel (and raise if
    it cannot build or launch)."""
    _check_inputs(im, u, v)
    with span("kernel::warp_bilinear"):
        if im.device.type == "cpu":
            return warp_bilinear_reference(im, u, v, both_orders)
        out = cuda.build().warp_bilinear(im, u, v, bool(both_orders))
    warp_bilinear.launches += 1
    return tuple(out) if both_orders else out[0]


warp_bilinear.launches = 0


def bilinear_sum(a, b, c, d, omx, wx, right_first: bool = False):
    """a*omx + b*wx + c*omx + d*wx (a..d the corners already weighted by
    their row) as XLA:CPU computes the JAX package's sum: left to right, the
    first two products in one fused multiply-add and each later product
    fused into the running sum. Which of the first two XLA:CPU fuses depends
    on the fusion that holds the warp: the left one, fma(a, omx, b * wx),
    where the warp feeds ``it`` or, recomputed, the gradients; the right
    one, fma(b, wx, a * omx), in the fusion that keeps the gradients in
    memory for several inners (``right_first``)."""
    first = (fma_f32(b, wx, a * omx) if right_first
             else fma_f32(a, omx, b * wx))
    return fma_f32(d, wx, fma_f32(c, omx, first))


def warp_bilinear_reference(im: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor, both_orders: bool = False):
    """The kernel's arithmetic with plain tensor ops (any device)."""
    b, h, w, c = im.shape
    dev = im.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1) + v
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w) + u
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    # The base corner stops at h-2 / w-2: on the last row or column the
    # fractional weight is then 1 and selects it.
    y0 = torch.floor(ys).to(torch.int64).clamp(max=h - 2)
    x0 = torch.floor(xs).to(torch.int64).clamp(max=w - 2)
    wy = (ys - y0.float())[..., None]
    wx = (xs - x0.float())[..., None]
    flat = im.reshape(b, h * w, c)
    idx = (y0 * w + x0).reshape(b, h * w, 1).expand(b, h * w, c)

    def corner(off):
        return torch.gather(flat, 1, idx + off).reshape(b, h, w, c)

    omy, omx = 1 - wy, 1 - wx
    rows = (corner(0) * omy, corner(1) * omy, corner(w) * wy,
            corner(w + 1) * wy, omx, wx)
    if both_orders:
        return bilinear_sum(*rows), bilinear_sum(*rows, right_first=True)
    return bilinear_sum(*rows)
