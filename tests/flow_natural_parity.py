"""Where the port's per-op flow parts from the JAX package's on the natural
240x320 frames (CPU; ``python tests/flow_natural_parity.py``, a few
minutes).

First the whole videos: the fraction of uint8 flow values within +-1 and
+-2, over the whole frame and beyond 8 px of the border, of

  * the port's per-op flow, as it is (a correctly rounded rsqrt) and with
    XLA:CPU's rsqrt for psi and phi, against the JAX package's XLA path and
    against the checked-in golden;
  * the JAX XLA path against the golden, compiled as the package compiles
    it (one program) and compiled level by level: the same code, which
    XLA:CPU fuses, and so rounds, differently.

Then level by level, coarsest first, on the JAX path's own inputs (its
pyramid images and upsampled flow), one outer at a time against JAX
``_flow_level`` with ``n_outer=1``. For each level and outer it prints the
share of psi and phi values that differ from XLA:CPU's, whether the IRLS
coefficients given XLA:CPU's psi and phi, the SOR solve given the JAX
coefficients, and the whole outer given XLA:CPU's rsqrt are bit-equal (the
share of equal values), and the largest difference of the outer with the
port's own rsqrt, relative to the values' magnitude. It names the first
(level, outer, operation) that is not bit-equal; the rsqrt is then the only
operation that departs.
"""

import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_flow_golden import NATURAL_GOLDEN, make_natural_frames  # noqa: E402
from video_classification_tpu.ops import flow as jflow  # noqa: E402
from video_classification_tpu_torch.ops import flow as tflow  # noqa: E402
from video_classification_tpu_torch.ops.fma import fma_f32, rsqrt_f32  # noqa: E402
from video_classification_tpu_torch.ops.sor_solve import sor_solve  # noqa: E402

P = jflow.FlowParams(backend="xla", warp="gather", fuse_level="off")
_xla_rsqrt = jax.jit(lambda x: 1.0 / jnp.sqrt(x))


def xla_rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``1 / jnp.sqrt`` (its rsqrt: the hardware estimate and two
    Newton steps) of a float32 tensor."""
    return torch.from_numpy(np.array(_xla_rsqrt(x.numpy())))


def _fractions(got, want, inner):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"pm1": float((d <= 1).mean()), "pm2": float((d <= 2).mean()),
            "pm2_inner8": float((d[:, inner] <= 2).mean())}


def _border_distance(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx))


def _jax_pyramids(im1, im2):
    shapes = jflow._pyramid_shapes(*im1.shape[1:3], P.ratio, P.min_width)
    sigma = (1.0 / P.ratio - 1.0) + 0.3
    step = jax.jit(lambda a, hw: jflow._resize_bilinear(
        jflow._gaussian_blur(a, sigma), hw), static_argnums=1)
    pyr1, pyr2 = [im1], [im2]
    for hw in shapes[1:]:
        pyr1.append(step(pyr1[-1], hw))
        pyr2.append(step(pyr2[-1], hw))
    return shapes, pyr1, pyr2


_upsample = jax.jit(lambda f, hw: jflow._resize_bilinear(f[..., None], hw)[..., 0],
                    static_argnums=1)


def _jax_level_by_level(im1, im2):
    """The JAX XLA path with each pyramid step, upsampling and level compiled
    on its own."""
    shapes, pyr1, pyr2 = _jax_pyramids(im1, im2)
    level = jax.jit(lambda a, b, u, v: jflow._flow_level(a, b, u, v, P))
    u = jnp.zeros((im1.shape[0],) + shapes[-1], jnp.float32)
    v = u
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if u.shape[1:] != (th, tw):
            sx, sy = tw / u.shape[2], th / u.shape[1]
            u, v = _upsample(u, (th, tw)) * sx, _upsample(v, (th, tw)) * sy
        u, v = level(pyr1[lvl], pyr2[lvl], u, v)
    return u, v


def compare_videos():
    frames = make_natural_frames()
    golden = np.load(NATURAL_GOLDEN)["flow_images"]
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    im1, im2 = jnp.concatenate([x[:1], x[:-1]]), x
    whole = np.asarray(jflow.video_flow_uint8(jnp.asarray(frames), P))
    by_level = np.asarray(jflow.encode_flow_uint8(*_jax_level_by_level(im1, im2)))
    tp = tflow.FlowParams(fuse_level="off")
    port = tflow.video_flow_uint8(torch.from_numpy(frames), tp).numpy()
    with mock.patch.object(tflow._flow_level_per_op, "__defaults__", (xla_rsqrt,)):
        port_xla_rsqrt = tflow.video_flow_uint8(torch.from_numpy(frames), tp).numpy()
    inner = _border_distance(240, 320) >= 8
    for name, got, want in (
            ("port vs JAX XLA", port, whole),
            ("port, XLA:CPU's rsqrt, vs JAX XLA", port_xla_rsqrt, whole),
            ("port vs golden", port, golden),
            ("port, XLA:CPU's rsqrt, vs golden", port_xla_rsqrt, golden),
            ("port, XLA:CPU's rsqrt, vs JAX XLA level by level", port_xla_rsqrt,
             by_level),
            ("JAX XLA vs golden", whole, golden),
            ("JAX XLA level by level vs golden", by_level, golden),
            ("JAX XLA level by level vs one program", by_level, whole)):
        print(name, _fractions(got, want, inner))
    return frames


def _equal(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@jax.jit
def _jax_outer(im1, im2, u, v):
    """One n_inner == 1 outer of the JAX XLA path (``_flow_level``'s code),
    returning the values XLA keeps in memory anyway: its psi and phi, the
    IRLS coefficients and the new flow."""
    warped = jflow._warp(im2, u, v, P)
    ix2, iy2 = jflow._grad_xy(warped)
    ix1, iy1 = jflow._grad_xy(im1)
    ix = 0.5 * (ix1 + ix2)
    iy = 0.5 * (iy1 + iy2)
    it = warped - im1
    du = jnp.zeros_like(u)
    dv = jnp.zeros_like(v)
    rho = it + ix * du[..., None] + iy * dv[..., None]
    psi = 1.0 / jnp.sqrt(rho * rho + P.eps)
    coeffs = [jnp.sum(psi * ix * ix, -1), jnp.sum(psi * ix * iy, -1),
              jnp.sum(psi * iy * iy, -1), -jnp.sum(psi * ix * it, -1),
              -jnp.sum(psi * iy * it, -1)]
    ux, uy = jflow._grad_xy((u + du)[..., None])
    vx, vy = jflow._grad_xy((v + dv)[..., None])
    mag = ux[..., 0] ** 2 + uy[..., 0] ** 2 + vx[..., 0] ** 2 + vy[..., 0] ** 2
    phi = 1.0 / jnp.sqrt(mag + P.eps)
    coeffs += list(jflow._edge_weights(phi))
    wu_, wd_, wl_, wr_ = coeffs[5:]
    a11, a12, a22, b1, b2 = coeffs[:5]
    red = jflow._checkerboard(*u.shape[1:])
    wsum = wu_ + wd_ + wl_ + wr_
    inv_u = 1.0 / (a11 + P.alpha * wsum)
    inv_v = 1.0 / (a22 + P.alpha * wsum)
    nu = jflow._weighted_neighbor_apply(u, wu_, wd_, wl_, wr_) - wsum * u
    nv = jflow._weighted_neighbor_apply(v, wu_, wd_, wl_, wr_) - wsum * v

    def half(du, dv, mask):
        su = nu + jflow._weighted_neighbor_apply(du, wu_, wd_, wl_, wr_)
        new = (b1 - a12 * dv + P.alpha * su) * inv_u
        du = jnp.where(mask, (1 - P.omega) * du + P.omega * new, du)
        sv = nv + jflow._weighted_neighbor_apply(dv, wu_, wd_, wl_, wr_)
        new = (b2 - a12 * du + P.alpha * sv) * inv_v
        dv = jnp.where(mask, (1 - P.omega) * dv + P.omega * new, dv)
        return du, dv

    du, dv = jax.lax.fori_loop(
        0, P.n_sor, lambda _, c: half(*half(*c, red), ~red), (du, dv))
    return u + du, v + dv, psi, phi, coeffs


def compare_levels(frames):
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    shapes, pyr1, pyr2 = _jax_pyramids(jnp.concatenate([x[:1], x[:-1]]), x)
    one = P._replace(n_outer=1)
    tp = tflow.FlowParams(fuse_level="off", n_outer=1)
    level = jax.jit(lambda a, b, u, v: jflow._flow_level(a, b, u, v, one))
    u = jnp.zeros((x.shape[0],) + shapes[-1], jnp.float32)
    v = jnp.zeros_like(u)
    first = None
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if u.shape[1:] != (th, tw):
            sx, sy = tw / u.shape[2], th / u.shape[1]
            u, v = _upsample(u, (th, tw)) * sx, _upsample(v, (th, tw)) * sy
        a, b = pyr1[lvl], pyr2[lvl]
        ta, tb = (torch.from_numpy(np.array(t)) for t in (a, b))
        for outer in range(P.n_outer):
            tu, tv = (torch.from_numpy(np.array(t)) for t in (u, v))
            ju, jv = level(a, b, u, v)
            cu, cv, jpsi, jphi, jco = _jax_outer(a, b, u, v)
            assert _equal(cu, ju) == _equal(cv, jv) == 1.0, "the copy is not _flow_level"
            ix, iy, it = tflow._outer_terms(ta, tb, tu, tv)
            z = torch.zeros_like(tu)
            ux, uy = tflow._grad_xy(tu, 1, 2)
            vx, vy = tflow._grad_xy(tv, 1, 2)
            row = {
                "psi differ": 1 - _equal(rsqrt_f32(fma_f32(it, it, P.eps)), jpsi),
                "phi differ": 1 - _equal(
                    rsqrt_f32(tflow.sum_of_squares(ux, uy, vx, vy) + P.eps), jphi)}
            given = iter([torch.from_numpy(np.array(jpsi)),
                          torch.from_numpy(np.array(jphi))])
            mine = tflow._normal_equations(ix, iy, it, tu, tv, z, z, P.eps,
                                           rsqrt=lambda _x: next(given))
            row["coefficients"] = min(_equal(m, c) for m, c in zip(mine, jco))
            tdu, tdv = sor_solve(*(torch.from_numpy(np.array(c)) for c in jco),
                                 tu, tv, P.n_sor, P.alpha, P.omega)
            row["sor"] = min(_equal(tu + tdu, ju), _equal(tv + tdv, jv))
            xu, xv = tflow._flow_level_per_op(ta, tb, tu, tv, tp, rsqrt=xla_rsqrt)
            row["outer, XLA rsqrt"] = min(_equal(xu, ju), _equal(xv, jv))
            pu, pv = tflow._flow_level_per_op(ta, tb, tu, tv, tp)
            row["outer rel diff"] = max(_rel(pu - tu, np.asarray(ju) - np.asarray(u)),
                                        _rel(pv - tv, np.asarray(jv) - np.asarray(v)))
            print(f"level {lvl} {th}x{tw} outer {outer}: " +
                  ", ".join(f"{k} {val:.4g}" for k, val in row.items()), flush=True)
            if first is None:
                bad = [k for k in ("coefficients", "sor", "outer, XLA rsqrt")
                       if row[k] < 1.0]
                if bad:
                    first = (lvl, outer, bad[0], row[bad[0]])
            u, v = ju, jv
    print("first operation not bit-equal:", first or "none (rsqrt alone departs)")
    return first


if __name__ == "__main__":
    torch.set_num_threads(4)
    jax.config.update("jax_platforms", "cpu")
    compare_levels(compare_videos())
