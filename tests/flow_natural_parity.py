"""Where the port's per-op flow parts from the JAX package's on the natural
240x320 frames (CPU; ``python tests/flow_natural_parity.py``, about a
minute).

Prints, over the whole frame and beyond 8 px of the border, the fraction of
uint8 flow values within +-1 and +-2 of: the port's per-op flow against the
JAX package's XLA path on this machine, the JAX path against its checked-in
golden, and the port against that golden.

Then level by level, coarsest first: the port's per-op level is fed the JAX
path's own inputs (its pyramid images and its upsampled flow) and run one
outer at a time against JAX ``_flow_level`` with ``n_outer=1`` on the same
inputs. For each level and outer it prints the largest difference, relative
to the values' magnitude, of the outer's image terms (ix, iy, it), the IRLS
coefficients of its first inner, the SOR solve given the JAX coefficients,
and the outer's whole update (``solve u``, ``solve v``), and names the first
(level, outer, operation) past ``ROUNDING``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_flow_golden import NATURAL_GOLDEN, make_natural_frames  # noqa: E402
from video_classification_tpu.ops import flow as jflow  # noqa: E402
from video_classification_tpu_torch.ops import flow as tflow  # noqa: E402
from video_classification_tpu_torch.ops.sor_solve import sor_solve  # noqa: E402

# Largest difference counted as float32 rounding, relative to the values'
# magnitude (a few ulps of 2**-23).
ROUNDING = 1e-6


def _fractions(got, want, inner):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"pm1": float((d <= 1).mean()), "pm2": float((d <= 2).mean()),
            "pm2_inner8": float((d[:, inner] <= 2).mean())}


def _border_distance(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx))


def compare_videos():
    frames = make_natural_frames()
    golden = np.load(NATURAL_GOLDEN)["flow_images"]
    jp = jflow.FlowParams(backend="xla", warp="gather", fuse_level="off")
    jax_flow = np.asarray(jflow.video_flow_uint8(jnp.asarray(frames), jp))
    port = tflow.video_flow_uint8(torch.from_numpy(frames),
                                  tflow.FlowParams(fuse_level="off")).numpy()
    inner = _border_distance(240, 320) >= 8
    for name, got, want in (("port vs JAX XLA", port, jax_flow),
                            ("JAX XLA vs golden", jax_flow, golden),
                            ("port vs golden", port, golden)):
        print(name, _fractions(got, want, inner))
    return frames


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_outer_terms(im1, im2, u, v, p):
    warped = jflow._warp(im2, u, v, p)
    ix2, iy2 = jflow._grad_xy(warped)
    ix1, iy1 = jflow._grad_xy(im1)
    return 0.5 * (ix1 + ix2), 0.5 * (iy1 + iy2), warped - im1


NAMES = ("a11", "a12", "a22", "b1", "b2", "wu", "wd", "wl", "wr")


@jax.jit
def _jax_coefficients(ix, iy, it, u, v):
    """The JAX XLA path's first inner (du = dv = 0; ``_flow_level``)."""
    p = jflow.DEFAULT_PARAMS
    psi = 1.0 / jnp.sqrt(it * it + p.eps)
    sums = [jnp.sum(psi * a * b, -1) for a, b in ((ix, ix), (ix, iy), (iy, iy))]
    ux, uy = jflow._grad_xy(u[..., None])
    vx, vy = jflow._grad_xy(v[..., None])
    mag = ux[..., 0] ** 2 + uy[..., 0] ** 2 + vx[..., 0] ** 2 + vy[..., 0] ** 2
    phi = 1.0 / jnp.sqrt(mag + p.eps)
    return (*sums, -jnp.sum(psi * ix * it, -1), -jnp.sum(psi * iy * it, -1),
            *jflow._edge_weights(phi))


@jax.jit
def _jax_sor(a11, a12, a22, b1, b2, wu, wd, wl, wr, u, v):
    """The JAX XLA path's SOR sweeps (``_flow_level``, no Pallas)."""
    p = jflow.DEFAULT_PARAMS
    red = jflow._checkerboard(*u.shape[1:])
    wsum = wu + wd + wl + wr
    inv_u = 1.0 / (a11 + p.alpha * wsum)
    inv_v = 1.0 / (a22 + p.alpha * wsum)
    nu = jflow._weighted_neighbor_apply(u, wu, wd, wl, wr) - wsum * u
    nv = jflow._weighted_neighbor_apply(v, wu, wd, wl, wr) - wsum * v

    def half(du, dv, mask):
        su = nu + jflow._weighted_neighbor_apply(du, wu, wd, wl, wr)
        new = (b1 - a12 * dv + p.alpha * su) * inv_u
        du = jnp.where(mask, (1 - p.omega) * du + p.omega * new, du)
        sv = nv + jflow._weighted_neighbor_apply(dv, wu, wd, wl, wr)
        new = (b2 - a12 * du + p.alpha * sv) * inv_v
        dv = jnp.where(mask, (1 - p.omega) * dv + p.omega * new, dv)
        return du, dv

    def body(_, c):
        return half(*half(*c, red), ~red)

    z = jnp.zeros_like(u)
    return jax.lax.fori_loop(0, p.n_sor, body, (z, z))


def compare_levels(frames):
    x = frames.astype(np.float32) / 255.0
    im1, im2 = np.concatenate([x[:1], x[:-1]]), x
    p = jflow.FlowParams(backend="xla", warp="gather", fuse_level="off")
    tp = tflow.FlowParams(fuse_level="off", n_outer=1)
    one = p._replace(n_outer=1)
    level = jax.jit(lambda a, b, u, v: jflow._flow_level(a, b, u, v, one))
    shapes = jflow._pyramid_shapes(240, 320, p.ratio, p.min_width)
    sigma = (1.0 / p.ratio - 1.0) + 0.3
    pyr1, pyr2 = [jnp.asarray(im1)], [jnp.asarray(im2)]
    for hw in shapes[1:]:
        pyr1.append(jflow._resize_bilinear(jflow._gaussian_blur(pyr1[-1], sigma), hw))
        pyr2.append(jflow._resize_bilinear(jflow._gaussian_blur(pyr2[-1], sigma), hw))
    u = jnp.zeros((3,) + shapes[-1], jnp.float32)
    v = jnp.zeros_like(u)
    first = None
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if u.shape[1:] != (th, tw):
            sx, sy = tw / u.shape[2], th / u.shape[1]
            u = jflow._resize_bilinear(u[..., None], (th, tw))[..., 0] * sx
            v = jflow._resize_bilinear(v[..., None], (th, tw))[..., 0] * sy
        a, b = pyr1[lvl], pyr2[lvl]
        ta, tb = (torch.from_numpy(np.array(t)) for t in (a, b))
        for outer in range(p.n_outer):
            tu, tv = (torch.from_numpy(np.array(t)) for t in (u, v))
            want = _jax_outer_terms(a, b, u, v, p)
            got = tflow._outer_terms(ta, tb, tu, tv)
            terms = {name: _rel(g, w) for name, g, w in zip(("ix", "iy", "it"), got, want)}
            coeffs = [np.asarray(c) for c in _jax_coefficients(*want, u, v)]
            mine = tflow._normal_equations(*got, tu, tv, torch.zeros_like(tu),
                                           torch.zeros_like(tv), p.eps)
            terms["coefficients"] = max(_rel(m, c) for m, c in zip(mine, coeffs))
            jdu, jdv = _jax_sor(*coeffs, u, v)
            tdu, tdv = sor_solve(*map(torch.from_numpy, coeffs), tu, tv, p.n_sor,
                                 p.alpha, p.omega)
            terms["sor du"], terms["sor dv"] = _rel(tdu, jdu), _rel(tdv, jdv)
            ju, jv = level(a, b, u, v)
            pu, pv = tflow._flow_level_per_op(ta, tb, tu, tv, tp)
            terms["solve u"] = _rel(pu - tu, np.asarray(ju) - np.asarray(u))
            terms["solve v"] = _rel(pv - tv, np.asarray(jv) - np.asarray(v))
            print(f"level {lvl} {th}x{tw} outer {outer}: " +
                  ", ".join(f"{k} {val:.3g}" for k, val in terms.items()))
            if first is None:
                bad = [k for k, val in terms.items() if val > ROUNDING]
                if bad:
                    first = (lvl, outer, bad[0], terms[bad[0]])
            u, v = ju, jv
    print("first past float32 rounding:", first)
    return first


if __name__ == "__main__":
    torch.set_num_threads(4)
    jax.config.update("jax_platforms", "cpu")
    compare_levels(compare_videos())
