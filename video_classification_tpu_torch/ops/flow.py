"""Coarse-to-fine variational optical flow, batched over frame pairs.

Port of the JAX package's ``ops/flow.py``: a Gaussian pyramid with downsample
``ratio`` (0.75) down to ``min_width`` (20), and per level ``n_outer``
relinearisations, each a bilinear warp, IRLS data and smoothness weights and
``n_sor`` red-black SOR sweeps; flow upsampled between levels. A level runs
one of two paths, as in the JAX package:

  * the fused level (``ops/flow_level.py``, kernel K1 on the card), the
    semantics of the JAX package's fused Pallas kernel: merged gradients, a
    warp clamped to +-``warp_radius`` px, a per-pair early exit after an
    outer that moves the pair by <= ``fuse_outer_tol``. Taken when
    ``n_inner == 1`` and ``fuse_level`` is "auto" or "on";
  * the per-op level (``_flow_level_per_op``), the JAX package's XLA path,
    which made the checked-in flow goldens: per-image gradients averaged, an
    unclamped warp (kernel K5, ``ops/warp.py``), every outer run, and
    ``n_inner`` inners per outer, each the IRLS coefficients (one kernel,
    ``ops/irls.py``) and a solve warm-started from the previous one (kernel
    K4, ``ops/sor_solve.py``). Taken when ``fuse_level`` is "off" or
    ``n_inner != 1``.

The JAX package's ``backend``, ``warp``, ``warp_tiers``, ``fuse_stack`` and
``fuse_warp_radius`` choose between TPU routes and have no counterpart here:
a CUDA tensor always launches the port's kernels and a CPU tensor always runs
their plain versions.

Tensors are channels-last (B, H, W, C) at the public functions, as in the
JAX package. The pyramid's bilinear resize computes what ``jax.image.resize(...,
"linear")`` computes (antialiased when it downsamples): its weight matrices,
rounded as XLA:CPU rounds them, contracted in float32.

A level computes XLA:CPU's arithmetic: every multiply-add that XLA:CPU fuses
into one rounding, compiling the JAX package's ``_flow_level``, is an exact
``ops/fma.fma_f32`` here (``ops/irls.py``,
``ops/flow_level.sum_of_squares``, ``ops/sor_solve.py``, ``ops/warp.py``),
so that given XLA:CPU's rsqrt each outer of the per-op level is bit-equal
to that function's at every level of the 240x320 and 96x128 pyramids, and
K1's plain version to the interpreted Pallas kernel
(``tests/test_torch_port_fma.py``). psi and phi take a correctly rounded
rsqrt (``ops/fma.rsqrt_f32``), the one departure: XLA:CPU's is the CPU's
hardware estimate refined by Newton steps, which no other device
reproduces; the two differ on 8-12 % of psi's and up to 10 % of phi's
values on the natural golden's frames (``tests/flow_natural_parity.py``).
The pyramid's resize (an XLA:CPU dot, its sum over the taps ordered by its
tiling) and blur are not held bit-equal.

``encode_flow_uint8`` is the on-disk encoding of the reference
(chalearn_video_to_flow.py:79-101): U, V clipped to +-5 -> [0, 1], magnitude
sqrt((U/5)^2 + (V/5)^2)/sqrt(2), all x255 and truncated to uint8.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.profiling import count
from .fma import rsqrt_f32
from .flow_level import flow_level
from .irls import data_terms, irls_coefficients
# The plain pieces of the per-op inner, which the tests, chip_smoke.py and
# time_components.py reach through this module.
from .flow_level import _grad_xy, sum_of_squares  # noqa: F401
from .irls import _normal_equations, channel_dot  # noqa: F401
from .sor_solve import sor_solve
from .warp import warp_bilinear


class FlowParams(NamedTuple):
    alpha: float = 0.012
    ratio: float = 0.75
    min_width: int = 20
    n_outer: int = 7
    n_inner: int = 1
    n_sor: int = 30
    omega: float = 1.8        # SOR over-relaxation
    eps: float = 1e-6         # Charbonnier epsilon^2
    warp_radius: int = 8      # warp offsets clamp at +-this many pixels
    # A pair's level stops once an outer moves it by <= this (px); 0 = always
    # run n_outer. The uint8 encoding's step is 10/255 ~ 0.039 px.
    fuse_outer_tol: float = 0.005
    # "auto" / "on": the fused level (K1) when n_inner == 1; "off": the
    # per-op level. warp_radius and fuse_outer_tol act on the fused level
    # only.
    fuse_level: str = "auto"


DEFAULT_PARAMS = FlowParams()
FUSE_LEVELS = ("auto", "on", "off")


def _edge_pad(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1).expand(*[r if d == dim else -1
                                         for d in range(x.dim())])
    last = x.narrow(dim, n - 1, 1).expand(*[r if d == dim else -1
                                            for d in range(x.dim())])
    return torch.cat([first, x, last], dim)


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over (B, H, W, C), edge-replicated."""
    radius = max(1, int(math.ceil(2.0 * sigma)))
    offsets = torch.arange(-radius, radius + 1, dtype=torch.float32,
                           device=x.device)
    k = torch.exp(-0.5 * (offsets / sigma) ** 2)
    k = k / torch.sum(k)

    def blur_axis(v, dim):
        vp = _edge_pad(v, dim, radius)
        out = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            out = out + k[i] * vp.narrow(dim, i, v.shape[dim])
        return out

    return blur_axis(blur_axis(x, 1), 2)


# XLA:CPU (jax 0.9.0), compiling jax.image.resize, rounds an axis' sample
# positions (i + 0.5) * (in / out) - 0.5 twice (multiply, then add) when the
# axis has fewer than this many outputs, and once (a fused multiply-add)
# from this many on: measured over output sizes 15-320.
_FMA_POSITIONS_FROM = 96


@functools.lru_cache(maxsize=256)
def _resize_taps(m: int, n: int, device: torch.device):
    """The nonzero columns of ``jax/_src/image/scale.py::compute_weight_mat``
    for a linear resize of one axis, ``m`` -> ``n`` samples, as XLA:CPU
    computes it in float32: the triangle kernel widened by ``max(m / n, 1)``
    when downsampling (``1 - |d| * (1 / width)`` rounded once), each column
    divided by its sum (taken in input order), and zero where the sample
    falls outside [-0.5, m - 0.5]. Returns (index, weight), each (k, n):
    output j takes sum over t of weight[t, j] * x[index[t, j]]."""
    f32 = np.float32
    inv = f32(1.0 / (n / m))
    width = f32(max(1.0 / (n / m), 1.0))
    pos = np.arange(n, dtype=f32) + f32(0.5)
    if n >= _FMA_POSITIONS_FROM:
        sample = (pos.astype(np.float64) * float(inv) - 0.5).astype(f32)
    else:
        sample = (pos * inv).astype(f32) - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(m, dtype=f32)[:, None])
    if width == 1:
        raw = f32(1) - dist
    else:
        raw = (1.0 - dist.astype(np.float64) * float(f32(1) / width)).astype(f32)
    raw = np.maximum(raw, f32(0))
    total = np.zeros(n, f32)
    for row in raw:
        total = total + row
    weights = np.where(np.abs(total) > f32(1000 * np.finfo(f32).eps),
                       raw / np.where(total != 0, total, f32(1)), f32(0))
    weights = np.where((sample >= -0.5) & (sample <= m - 0.5), weights, f32(0))
    nonzero = weights != 0
    first = nonzero.argmax(axis=0)
    k = max(int(nonzero.sum(axis=0).max()), 1)
    rows = first[None, :] + np.arange(k)[:, None]
    index = np.minimum(rows, m - 1)
    taps = np.where(rows < m, np.take_along_axis(weights, index, axis=0), f32(0))
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(taps.astype(f32)).to(device))


def _resize_axis(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    m = x.shape[dim]
    if m == n:
        return x
    index, taps = _resize_taps(m, n, x.device)
    shape = [n if d == dim else 1 for d in range(x.dim())]
    out = None
    for t in range(index.shape[0]):
        term = x.index_select(dim, index[t]) * taps[t].view(shape)
        out = term if out is None else out + term
    return out


def _resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): ``jax.image.resize(..., "linear")``,
    antialiased when downsampling: H, then W, each a float32 sum over the
    few nonzero taps of the axis' weight matrix, in input order (elementwise
    ops only, so no TF32 on the card)."""
    return _resize_axis(_resize_axis(x, 1, hw[0]), 2, hw[1]).contiguous()


def _pyramid_shapes(h: int, w: int, ratio: float, min_width: int):
    """Level shapes, finest first (level 0 = original)."""
    shapes = [(h, w)]
    while True:
        nh, nw = int(round(shapes[-1][0] * ratio)), int(round(shapes[-1][1] * ratio))
        if min(nh, nw) < min_width:
            break
        shapes.append((nh, nw))
    return shapes


def _use_fused_level(p: FlowParams) -> bool:
    if p.fuse_level not in FUSE_LEVELS:
        raise ValueError(f"fuse_level must be one of {FUSE_LEVELS}, got "
                         f"{p.fuse_level!r}")
    return p.n_inner == 1 and p.fuse_level != "off"


def _warps(im2: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           n_inner: int = 1):
    """(warped, warped_grad): im2 warped by (u, v) (K5), and the same warp as
    the outer's gradients take it.

    XLA:CPU rounds the warp in each fusion that holds it. With one inner the
    gradients and ``it`` fuse the same order of the warp's first fused
    multiply-add, so both are one tensor; when several inners reuse the
    terms, the fusion that keeps the gradients in memory fuses the other
    order (``ops/warp.bilinear_sum``), so K5 returns both."""
    if n_inner > 1:
        return warp_bilinear(im2, u, v, both_orders=True)
    warped = warp_bilinear(im2, u, v)
    return warped, warped


def _outer_terms(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, n_inner: int = 1):
    """(ix, iy, it), each (B, H, W, C), of one outer: im2 warped by (u, v)
    (K5, ``_warps``), the mean of both images' gradients, the temporal
    difference (``ops/irls.data_terms``)."""
    return data_terms(im1, *_warps(im2, u, v, n_inner))


def _flow_level_per_op(im1: torch.Tensor, im2: torch.Tensor, u: torch.Tensor,
                       v: torch.Tensor, p: FlowParams, rsqrt=rsqrt_f32):
    """Refine (u, v) at one level along the JAX package's XLA path
    (``ops/flow.py::_flow_level``): per outer one warp (K5) and ``n_inner``
    warm-started inners, each the IRLS coefficients (the IRLS kernel,
    ``ops/irls.py``) and a solve (K4); every outer runs. ``rsqrt`` as in
    ``_normal_equations`` (CPU tensors only)."""
    for _outer in range(p.n_outer):
        warped, warped_grad = _warps(im2, u, v, p.n_inner)
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for _inner in range(p.n_inner):
            coeffs = irls_coefficients(im1, warped, warped_grad, u, v, du, dv,
                                       p.eps, rsqrt)
            du, dv = sor_solve(*coeffs, u, v, p.n_sor, p.alpha, p.omega,
                               du, dv)
        u = u + du
        v = v + dv
    return u, v


def coarse2fine_flow(im1: torch.Tensor, im2: torch.Tensor,
                     params: FlowParams = DEFAULT_PARAMS):
    """Dense flow for a batch of frame pairs.

    im1, im2: (B, H, W, C) in [0, 1]. Returns (u, v), each (B, H, W) float32,
    in pixels."""
    fused = _use_fused_level(params)
    count("flow.pairs", im1.shape[0])
    im1 = im1.float()
    im2 = im2.float()
    b, h, w, _ = im1.shape
    shapes = _pyramid_shapes(h, w, params.ratio, params.min_width)

    # Both images' pyramids in one batch, and u and v upsampled as two
    # channels: the blur and the resize work per image and channel, so the
    # values are those of separate calls, in half the launches.
    sigma = (1.0 / params.ratio - 1.0) + 0.3
    pyr = [torch.cat([im1, im2])]
    for hw in shapes[1:]:
        pyr.append(_resize_bilinear(_gaussian_blur(pyr[-1], sigma), hw))

    ch, cw = shapes[-1]
    u = torch.zeros((b, ch, cw), dtype=torch.float32, device=im1.device)
    v = torch.zeros_like(u)
    for lvl in range(len(shapes) - 1, -1, -1):
        th, tw = shapes[lvl]
        if (u.shape[1], u.shape[2]) != (th, tw):
            scale_x = tw / u.shape[2]
            scale_y = th / u.shape[1]
            uv = _resize_bilinear(torch.stack([u, v], -1), (th, tw))
            u, v = uv[..., 0] * scale_x, uv[..., 1] * scale_y
        u, v = u.contiguous(), v.contiguous()
        pyr1, pyr2 = pyr[lvl][:b], pyr[lvl][b:]
        if fused:
            u, v, _ = flow_level(pyr1, pyr2, u, v, params.n_outer,
                                 params.n_sor, params.alpha, params.omega,
                                 params.eps, params.warp_radius,
                                 params.fuse_outer_tol)
        else:
            u, v = _flow_level_per_op(pyr1, pyr2, u, v, params)
    return u, v


def encode_flow_uint8(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) flow image: [U, V, magnitude] channels."""
    uc = torch.clamp(u, -5.0, 5.0)
    vc = torch.clamp(v, -5.0, 5.0)
    mag = torch.sqrt(torch.square(uc / 5.0) + torch.square(vc / 5.0)) / math.sqrt(2.0)
    mag = torch.clamp(mag, 0.0, 1.0)
    f01 = torch.stack([(uc + 5.0) / 10.0, (vc + 5.0) / 10.0, mag], dim=-1)
    return (f01 * 255.0).to(torch.uint8)


def video_flow_uint8(frames: torch.Tensor,
                     params: FlowParams = DEFAULT_PARAMS) -> torch.Tensor:
    """Per-frame flow images for a video (T, H, W, C) -> (T, H, W, 3) uint8.

    Frame t's flow is computed against frame t-1; frame 0 flows against
    itself (zero motion), the reference's first-frame convention
    (chalearn_video_to_flow.py:62-66). All T pairs are solved as one batch."""
    x = frames.float() / 255.0
    prev = torch.cat([x[:1], x[:-1]], dim=0)
    u, v = coarse2fine_flow(prev, x, params)
    return encode_flow_uint8(u, v)


def flow_energy_filter(flow_images: torch.Tensor, keep_fraction: float = 0.3,
                       min_keep: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-energy frames of (T, H, W, 3) flow images
    (chalearn_filter_img_by_flow.py:43-66, as the JAX package reads it).

    energy = mean of the magnitude channel. Keeps min(T, max(min_keep,
    int(T * keep_fraction))) frames. Returns (kept indices sorted ascending,
    energies (T,) float32). Among equal energies the lower index is kept
    first, ``jax.lax.top_k``'s order, which ``torch.topk`` does not promise:
    hence a stable descending sort."""
    t = flow_images.shape[0]
    num_keep = min(t, max(min_keep, int(t * keep_fraction)))
    energy = flow_images[..., 2].float().mean(dim=(1, 2))
    order = torch.sort(energy, descending=True, stable=True).indices
    return torch.sort(order[:num_keep]).values, energy
