"""Exact float32 fused multiply-adds and reciprocal square roots, on any device.

XLA:CPU, compiling the JAX package's flow, contracts a multiply feeding an
add into one fused multiply-add (LLVM's ``fma``, rounded once), and the
flow's plain versions in this port repeat those contractions where XLA makes
them (``ops/flow.py``, ``ops/sor_solve.py``, ``ops/flow_level.py``); the
kernels make the same ones with ``__fmaf_rn``. PyTorch has no float32 fma
that is the same on every device, so ``fma_f32`` builds it from float64:

  * ``a * b`` of two float32 values is exact in float64 (48 bits);
  * ``s = a * b + c`` is rounded to float64 once, and its error ``e`` is
    recovered exactly (Knuth's TwoSum);
  * ``s`` is rounded to odd: where ``e != 0`` and the last bit of ``s`` is
    even, ``s`` steps one float64 ulp towards ``e``;
  * and is rounded once to float32.

Rounding to odd in a format at least two bits wider than the target makes
the second rounding exact (Boldo and Melquiond, "Emulation of FMA and
correctly rounded sums: proved algorithms using rounding to odd", IEEE TC
2008), so the result is IEEE ``fmaf`` on every input: signed zeros,
subnormals, infinities and NaN included. XLA:CPU runs with subnormals
flushed to zero, in and out, so there the two agree up to that flush.

Where XLA:CPU fuses is LLVM's choice, made per fusion: ``a*b + c`` whenever
both are in one fusion, and of two products meeting in one add the one that
the fusion's code reaches first, which the JAX source does not always show. Each site in the
port's flow was found by running the JAX functions, compiled as the JAX
package compiles them, against the candidates built from ``fma_f32``.

``rsqrt_f32`` is ``1 / sqrt(x)`` correctly rounded to float32: float64
``sqrt`` and divide, rounded once (correctly rounded for every float32
input, ``tests/test_torch_port_fma.py``). XLA:CPU instead rewrites
``1 / sqrt(x)`` to ``rsqrt`` and lowers it to the CPU's hardware estimate
refined by two Newton steps, whose last bits follow the vendor's table: no
other device reproduces them. The correctly rounded value is the same on
the CPU and the card (``__frsqrt_rn``), and it is the flow's one named
departure from the JAX package (``ops/flow.py``).
"""

from __future__ import annotations

import torch


# A float64 whose bits below float32's last one read 1000...0 lies on a
# float32 rounding midpoint.
_BELOW_F32 = (1 << 29) - 1
_MIDPOINT = 1 << 28
# A nonzero float64 below float32's smallest normal: the bits of |s|, less
# one, below those of 2**-126 less one as unsigned integers (zero wraps to
# the top), which signed integers compare with the sign bit flipped.
_ABS = (1 << 63) - 1
_SIGN = -(1 << 63)
_TINY_BELOW = (((1023 - 126) << 52) - 1) ^ _SIGN


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    return float(torch.tensor(x, dtype=torch.float32))


def _round_to_odd_f32(p: torch.Tensor, c) -> torch.Tensor:
    """float32(p + c), rounded once, for a float64 product p."""
    s = p + c
    # TwoSum: s + e == p + c exactly.
    pp = s - c
    e = (p - pp).add_(c - (s - pp))
    # Round to odd: an inexact s with an even last bit moves one ulp towards
    # p + c, i.e. its bits move by sign(e) * sign(s) (s != 0 where e != 0;
    # e is NaN only where s is not finite, which stays as it is).
    bits = s.view(torch.int64)
    step = torch.sign(e).mul_(torch.sign(s)).nan_to_num_(0.0).to(torch.int64)
    return bits.add_(step.mul_((bits & 1) == 0)).view(torch.float64).float()


def fma_f32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (IEEE ``fmaf``), broadcast; each
    argument a float32 tensor (or a float64 one that holds float32 values)
    or a Python float, taken as float32.

    On the CPU the float64 sum is rounded to float32 directly, and only the
    values that fell on a float32 rounding midpoint, or below float32's
    smallest normal, where that second rounding can differ from the single
    one, are rounded again through rounding to odd. Elsewhere every value is
    rounded to odd: finding the few would make the host wait for the
    device."""
    a, b, c = _f64(a), _f64(b), _f64(c)
    if next(x for x in (a, b, c) if isinstance(x, torch.Tensor)).device.type != "cpu":
        return _round_to_odd_f32(a * b, c)
    # c + a * b in float64: the product is exact, the sum rounded once.
    if all(isinstance(x, torch.Tensor) for x in (a, b, c)):
        s = torch.addcmul(c, a, b)
    else:
        s = a * b + c
    out = s.float()
    bits = s.view(torch.int64)
    tiny = (bits & _ABS).sub_(1).bitwise_xor_(_SIGN) < _TINY_BELOW
    midpoint = (bits & _BELOW_F32) == _MIDPOINT
    # A bool tensor's bytes' max is a much faster "any" on the CPU.
    if s.numel() and (bool(tiny.view(torch.uint8).max())
                      or bool(midpoint.view(torch.uint8).max())):
        at = tiny.logical_or_(midpoint).nonzero(as_tuple=True)
        a, b, c = (x.expand(s.shape)[at] if isinstance(x, torch.Tensor) else x
                   for x in (a, b, c))
        out[at] = _round_to_odd_f32(a * b, c)
    return out


def rsqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``1 / sqrt(x)``, correctly rounded (float64, rounded once)."""
    return (1.0 / torch.sqrt(x.double())).float()
