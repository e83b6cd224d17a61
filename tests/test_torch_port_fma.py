"""The flow's fused multiply-adds: the port computes XLA:CPU's arithmetic (CPU).

XLA:CPU contracts a multiply that feeds an add into one fused multiply-add
where LLVM chooses to; the port's plain flow makes the same contractions
explicit with ``ops/fma.fma_f32`` (the kernels with ``__fmaf_rn``). Held here:

  * ``fma_f32`` against ``jax.jit(lambda a, b, c: a * b + c)`` on random
    values, on values built so that a float64 sum lands on a float32
    rounding midpoint, and on signed zeros, infinities and NaN; XLA:CPU
    flushes subnormals to zero, so there ``fma_f32`` is held to the exact
    rational result instead (and to XLA up to the flush); rounding to odd
    everywhere gives its values;
    ``ops/image._lerp_fma`` is it; ``rsqrt_f32`` is correctly rounded on
    every float32 of [1, 4);
  * each contraction site of the flow, at every level shape of the 240x320
    and 96x128 pyramids: the port's expression against ``jax.jit`` of the
    JAX package's, bit-equal;
  * in context: one outer of JAX ``_flow_level`` (the XLA path) against the
    port's, at the coarsest level and at one of 96 outputs or more: the IRLS
    coefficients given XLA:CPU's psi and phi, the SOR solve from the JAX
    coefficients, and the whole outer given XLA:CPU's rsqrt, bit-equal;
    several inners and outers; K1's and K4's plain versions against the
    Pallas kernels run in interpret mode.
Inputs are made with numpy from seeds.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_natural_parity import _jax_outer, xla_rsqrt
from test_torch_port_flow import _pairs
from test_torch_port_sor_solve import _system
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu.ops.pallas_flow import (
    flow_level_fused_pallas, sor_solve_pallas)
from video_classification_tpu_torch.ops import fma as fma_mod
from video_classification_tpu_torch.ops import flow as tflow
from video_classification_tpu_torch.ops import image
from video_classification_tpu_torch.ops.flow_level import flow_level_reference
from video_classification_tpu_torch.ops.fma import fma_f32, rsqrt_f32
from video_classification_tpu_torch.ops.sor_solve import (
    _neighbour, hoisted, relax, sor_solve_reference)
from video_classification_tpu_torch.ops.warp import warp_bilinear_reference
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

_xla_fma = jax.jit(lambda a, b, c: a * b + c)
P = jflow.FlowParams(backend="xla", warp="gather", fuse_level="off")
LEVELS = sorted(set(jflow._pyramid_shapes(240, 320, 0.75, 20)
                    + jflow._pyramid_shapes(96, 128, 0.75, 20)))
f32 = np.float32


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} of {same.size} differ"


def _port_fma(a, b, c):
    return fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()


def _midpoint_cases(n, seed):
    """a * b + c whose float64 sum rounds onto a float32 midpoint: c has an
    odd last bit and a * b = +-2**-24 * ulp(1) * (1 - x*x) just misses half
    an ulp of c (x = k * 2**-23)."""
    rng = np.random.RandomState(seed)
    k = rng.randint(1, 2 ** 11, n).astype(np.float64)
    e = rng.randint(-20, 20, n)
    mant = 1 + (2 * rng.randint(0, 2 ** 22, n) + 1) * 2.0 ** -23
    a = (1 + k * 2 ** -23).astype(f32)
    b = (rng.choice([-1.0, 1.0], n) * (1 - k * 2 ** -23) * 2.0 ** (e - 24)).astype(f32)
    c = (rng.choice([-1.0, 1.0], n) * mant * 2.0 ** e).astype(f32)
    return a, b, c


def test_fma_matches_xla_on_random_values():
    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(3, 100003) * rng.choice([1e-3, 1.0, 1e3], (3, 100003))).astype(f32)
    want = np.asarray(_xla_fma(a, b, c))
    _bits_equal(_port_fma(a, b, c), want)
    assert (((a * b + c).view(np.int32)) != want.view(np.int32)).mean() > 0.1


@pytest.mark.parametrize("seed", [1, 2])
def test_fma_matches_xla_on_float32_midpoints(seed):
    """Where float64 rounding then float32 rounding would differ from one
    rounding: most of these cases."""
    a, b, c = _midpoint_cases(50000, seed)
    want = np.asarray(_xla_fma(a, b, c))
    _bits_equal(_port_fma(a, b, c), want)
    twice = (a.astype(np.float64) * b + c).astype(f32)
    assert (twice.view(np.int32) != want.view(np.int32)).mean() > 0.1


def test_fma_matches_xla_on_signed_zeros_and_infinities():
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3.4e38,
                     -3.4e38, 1e-10, 2.5], f32)
    a, b, c = (g.ravel() for g in np.meshgrid(vals, vals, vals, indexing="ij"))
    _bits_equal(_port_fma(a, b, c), np.asarray(_xla_fma(a, b, c)))


def _exact_fma(a, b, c):
    """float32 of the exact rational a * b + c, ties to even."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = f32(float(x))
    lo, hi = sorted((r, np.nextafter(r, f32(np.inf) if Fraction(float(r)) < x else f32(-np.inf))))
    dlo, dhi = abs(x - Fraction(float(lo))), abs(x - Fraction(float(hi)))
    if dlo != dhi:
        return lo if dlo < dhi else hi
    return lo if lo.view(np.int32) % 2 == 0 else hi


def test_fma_is_ieee_on_subnormals_where_xla_flushes():
    """XLA:CPU computes FTZ(fmaf(DAZ(a), DAZ(b), DAZ(c))); fma_f32 is fmaf."""
    rng = np.random.RandomState(3)
    n = 400
    a = (rng.randn(n) * rng.choice([1e-19, 1e-40, 10.0], n)).astype(f32)
    b = (rng.randn(n) * rng.choice([1e-19, 1.0], n)).astype(f32)
    c = (rng.randn(n) * rng.choice([1e-38, 1e-44, 0.0], n)).astype(f32)
    got = _port_fma(a, b, c)
    _bits_equal(got, np.array([_exact_fma(*t) for t in zip(a, b, c)], f32))
    tiny = np.finfo(f32).tiny

    def flush(x):
        return np.where(np.abs(x) < tiny, np.copysign(f32(0), x), x).astype(f32)

    _bits_equal(flush(_port_fma(flush(a), flush(b), flush(c))),
                np.asarray(_xla_fma(a, b, c)))
    assert (np.abs(got) < tiny).sum() > 50


def test_rounding_to_odd_everywhere_equals_the_fast_path():
    """fma_f32 rounds to odd only where the float64 sum is at risk; doing
    so everywhere gives the same values."""
    a, b, c = _midpoint_cases(20000, 4)
    rng = np.random.RandomState(5)
    a = np.concatenate([a, rng.randn(20000).astype(f32), np.zeros(100, f32)])
    b = np.concatenate([b, rng.randn(20000).astype(f32), np.ones(100, f32)])
    c = np.concatenate([c, (rng.randn(20000) * 1e-39).astype(f32), np.zeros(100, f32)])
    ta, tb, tc = map(torch.from_numpy, (a, b, c))
    odd = fma_mod._round_to_odd_f32(ta.double() * tb.double(), tc.double())
    assert torch.equal(odd.view(torch.int32), fma_f32(ta, tb, tc).view(torch.int32))


def test_cv2_lerp_is_the_fused_multiply_add():
    """a + (b - a) * f, which XLA:CPU fuses as cv2 does."""
    rng = np.random.RandomState(6)
    a, b, f = rng.rand(3, 100003).astype(f32)
    want = jax.jit(lambda a, b, f: a + (b - a) * f)(a, b, f)
    _bits_equal(image._lerp_fma(*map(torch.from_numpy, (a, b, f))).numpy(), want)


def _not_nearest(x):
    """How many of rsqrt_f32(x) have a float32 neighbour nearer 1/sqrt(x)."""
    got = rsqrt_f32(torch.from_numpy(x)).numpy()
    exact = 1 / np.sqrt(x.astype(np.longdouble))
    err = np.abs(got.astype(np.longdouble) - exact)
    return sum(int((err > np.abs(np.nextafter(got, f32(side)).astype(np.longdouble)
                                 - exact)).sum()) for side in (np.inf, 0))


def test_rsqrt_is_correctly_rounded():
    """Every float32 in [1, 4), which is every float32 up to a power of 4
    that both 1/sqrt and the float64 arithmetic carry exactly; and a sweep
    of exponents, subnormals included."""
    lo, hi = (int(f32(x).view(np.uint32)) for x in (1.0, 4.0))
    for start in range(lo, hi, 1 << 21):
        x = np.arange(start, min(start + (1 << 21), hi), dtype=np.uint32).view(f32)
        assert _not_nearest(x) == 0
    rng = np.random.RandomState(7)
    assert _not_nearest((10.0 ** rng.uniform(-44, 38, 200000)).astype(f32)) == 0


# -- each contraction site, the port's expression against the JAX one --------

def _fields(shape, seed, n, scale=1.0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*shape) * scale).astype(f32)) for _ in range(n)]


def _site_rho(shape, seed):
    ix, iy, it = _fields(shape + (3,), seed, 3)
    du, dv = _fields(shape, seed + 1, 2, 0.3)
    want = jax.jit(lambda ix, iy, it, du, dv: it + ix * du[..., None] + iy * dv[..., None])(
        ix.numpy(), iy.numpy(), it.numpy(), du.numpy(), dv.numpy())
    got = fma_f32(iy, dv[..., None], fma_f32(ix, du[..., None], it))
    return got, want


def _site_charbonnier(shape, seed):
    (rho,) = _fields(shape + (3,), seed, 1, 0.01)
    want = jax.jit(lambda r: r * r + P.eps)(rho.numpy())
    return fma_f32(rho, rho, P.eps), want


def _site_channel_dot(shape, seed):
    psi, ix, iy = _fields(shape + (3,), seed, 3)
    want = jax.jit(lambda p, x, y: jnp.sum(p * x * y, -1))(psi.numpy(), ix.numpy(), iy.numpy())
    return tflow.channel_dot(psi, ix, iy), want


def _site_magnitude(shape, seed):
    u, v = _fields(shape, seed, 2, 3.0)

    def jax_magnitude(u, v):
        ux, uy = jflow._grad_xy(u[..., None])
        vx, vy = jflow._grad_xy(v[..., None])
        return ux[..., 0] ** 2 + uy[..., 0] ** 2 + vx[..., 0] ** 2 + vy[..., 0] ** 2

    want = jax.jit(jax_magnitude)(u.numpy(), v.numpy())
    return tflow.sum_of_squares(*tflow._grad_xy(u, 1, 2), *tflow._grad_xy(v, 1, 2)), want


def _site_neighbour(shape, seed):
    f, wu, wd, wl, wr = _fields(shape, seed, 5)
    want = jax.jit(jflow._weighted_neighbor_apply)(*(t.numpy() for t in (f, wu, wd, wl, wr)))
    return _neighbour(f, wu, wd, wl, wr), want


def _site_hoisted(shape, seed):
    a11, a22, wu, wd, wl, wr, u, v = (t.abs() for t in _fields(shape, seed, 8))

    def jax_hoisted(a11, a22, wu, wd, wl, wr, u, v):
        wsum = wu + wd + wl + wr
        return (1.0 / (a11 + P.alpha * wsum), 1.0 / (a22 + P.alpha * wsum),
                jflow._weighted_neighbor_apply(u, wu, wd, wl, wr) - wsum * u,
                jflow._weighted_neighbor_apply(v, wu, wd, wl, wr) - wsum * v)

    args = (a11, a22, wu, wd, wl, wr, u, v)
    want = jax.jit(jax_hoisted)(*(t.numpy() for t in args))
    return torch.stack(hoisted(*args, P.alpha)), np.stack(want)


def _site_relax(shape, seed):
    d, d_other, b, a12, s, inv = _fields(shape, seed, 6)

    def jax_relax(d, d_other, b, a12, s, inv):
        new = (b - a12 * d_other + P.alpha * s) * inv
        return (1 - P.omega) * d + P.omega * new

    args = (d, d_other, b, a12, s, inv)
    want = jax.jit(jax_relax)(*(t.numpy() for t in args))
    return relax(*args, P.alpha, P.omega), want


def _site_warp(shape, seed):
    rng = np.random.RandomState(seed)
    im = rng.rand(*shape, 3).astype(f32)
    u, v = ((rng.rand(2, *shape) - 0.5) * 8).astype(f32)
    want = jax.jit(jflow._warp_bilinear)(im, u, v)
    return warp_bilinear_reference(*map(torch.from_numpy, (im, u, v))), want


SITES = {"rho": _site_rho, "charbonnier": _site_charbonnier,
         "channel_dot": _site_channel_dot, "magnitude": _site_magnitude,
         "neighbour": _site_neighbour, "hoisted": _site_hoisted,
         "relax": _site_relax, "warp": _site_warp}


@pytest.mark.parametrize("hw", LEVELS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("site", sorted(SITES))
def test_contraction_site_matches_xla(site, hw):
    got, want = SITES[site]((2,) + hw, seed=hw[0] * 7 + hw[1])
    _bits_equal(got.numpy(), np.asarray(want))


# -- in context: _flow_level's outers ----------------------------------------

def _level_inputs(h, w, b=2, seed=0):
    im1, im2 = _pairs(b, h, w, seed=h + seed)
    rng = np.random.RandomState(w + seed)
    u = ((rng.rand(b, h, w) - 0.5) * 4).astype(f32)
    v = ((rng.rand(b, h, w) - 0.5) * 4).astype(f32)
    return im1, im2, u, v


@pytest.mark.parametrize("hw", [(24, 32), (101, 135)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_outer_is_bit_equal_to_flow_level(hw):
    """At the coarsest level of the 240x320 pyramid and at one of 96 outputs
    or more: the IRLS coefficients given XLA:CPU's psi and phi, the SOR from
    the JAX coefficients, and the whole outer given XLA:CPU's rsqrt."""
    im1, im2, u, v = _level_inputs(*hw)
    level = jax.jit(lambda a, b, u, v: jflow._flow_level(a, b, u, v, P._replace(n_outer=1)))
    ju, jv = level(im1, im2, u, v)
    cu, cv, jpsi, jphi, jco = _jax_outer(im1, im2, u, v)
    _bits_equal(cu, ju)
    _bits_equal(cv, jv)
    ta, tb, tu, tv = map(torch.from_numpy, (im1, im2, u, v))
    ix, iy, it = tflow._outer_terms(ta, tb, tu, tv)
    given = iter([torch.from_numpy(np.array(jpsi)), torch.from_numpy(np.array(jphi))])
    z = torch.zeros_like(tu)
    coeffs = tflow._normal_equations(ix, iy, it, tu, tv, z, z, P.eps,
                                     rsqrt=lambda _x: next(given))
    for got, want in zip(coeffs, jco):
        _bits_equal(got.numpy(), want)
    du, dv = sor_solve_reference(*(torch.from_numpy(np.array(c)) for c in jco),
                                 tu, tv, P.n_sor, P.alpha, P.omega)
    _bits_equal((tu + du).numpy(), ju)
    _bits_equal((tv + dv).numpy(), jv)
    pu, pv = tflow._flow_level_per_op(ta, tb, tu, tv, tflow.FlowParams(n_outer=1),
                                      rsqrt=xla_rsqrt)
    _bits_equal(pu.numpy(), ju)
    _bits_equal(pv.numpy(), jv)


@pytest.mark.parametrize("n_outer,n_inner", [(2, 1), (1, 2), (2, 3)])
def test_level_is_bit_equal_given_xla_rsqrt(n_outer, n_inner):
    """Several outers, and several inners, whose reused gradients XLA:CPU
    rounds with the other order of the warp's first fused multiply-add."""
    im1, im2, u, v = _level_inputs(43, 57, seed=n_inner)
    jp = P._replace(n_outer=n_outer, n_inner=n_inner)
    ju, jv = jax.jit(lambda a, b, u, v: jflow._flow_level(a, b, u, v, jp))(im1, im2, u, v)
    tp = tflow.FlowParams(n_outer=n_outer, n_inner=n_inner, fuse_level="off")
    pu, pv = tflow._flow_level_per_op(*map(torch.from_numpy, (im1, im2, u, v)), tp,
                                      rsqrt=xla_rsqrt)
    _bits_equal(pu.numpy(), ju)
    _bits_equal(pv.numpy(), jv)


@pytest.mark.parametrize("hw", [(20, 28), (43, 57)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_plain_k1_is_bit_equal_to_interpreted_pallas(hw):
    """K1's plain version against ``_flow_level_kernel`` run in interpret
    mode, given XLA:CPU's rsqrt, with its outer loop of two trips or more."""
    im1, im2, u, v = _level_inputs(*hw, seed=3)
    p = jflow.FlowParams(n_outer=3, n_sor=10, fuse_level="interpret", fuse_outer_tol=0.0)
    ju, jv, jmx = flow_level_fused_pallas(*map(jnp.asarray, (im1, im2, u, v)), p,
                                          interpret=True)
    tu, tv, tmx = flow_level_reference(*map(torch.from_numpy, (im1, im2, u, v)),
                                       p.n_outer, p.n_sor, p.alpha, p.omega, p.eps,
                                       p.warp_radius, 0.0, rsqrt=xla_rsqrt)
    _bits_equal(tu.numpy(), ju)
    _bits_equal(tv.numpy(), jv)
    _bits_equal(tmx.numpy(), jmx)


@pytest.mark.parametrize("warm", [False, True])
def test_plain_k4_is_bit_equal_to_interpreted_pallas(warm):
    """K4's plain version against ``_sor_kernel`` run in interpret mode, its
    sweeps all inside its loop (n_sor even, >= 4)."""
    arrays = _system(2, 43, 57, seed=11, warm=warm)
    jdu, jdv = sor_solve_pallas(*map(jnp.asarray, arrays[:11]), 8, P.alpha, P.omega,
                                True, du0=jnp.asarray(arrays[11]),
                                dv0=jnp.asarray(arrays[12]))
    t = [torch.from_numpy(a) for a in arrays]
    du, dv = sor_solve_reference(*t[:11], 8, P.alpha, P.omega, t[11], t[12])
    _bits_equal(du.numpy(), jdu)
    _bits_equal(dv.numpy(), jdv)
