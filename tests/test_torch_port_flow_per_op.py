"""Per-op flow parity of the PyTorch port against the JAX package (CPU).

The per-op level is the JAX package's XLA path (``ops/flow.py::_flow_level``
with the fused level off, or ``n_inner != 1``): per outer one unclamped warp
(K5) and ``n_inner`` warm-started SOR solves (K4). Held here:

  * the port's per-op level (plain K4 and K5) against JAX ``_flow_level``
    with the XLA loop and gather warp, and with the interpreted Pallas
    solve, for n_inner 1 and 2, zero and random initial flow, at a shape
    that is not tile-aligned;
  * ``coarse2fine_flow`` and ``video_flow_uint8`` on the per-op path
    against the JAX package's;
  * the three checked-in flow goldens, which the JAX per-op path made, at
    their golden tests' bars;
  * ``flow_energy_filter`` against the JAX function, ties included;
  * the dispatch: which level each ``fuse_level`` / ``n_inner`` takes.
Inputs are made with numpy from seeds and handed to both.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_flow_golden import SMALL_PARAMS, make_frames, make_natural_frames
from test_torch_port_flow import _border_distance, _pairs, _uint8_within
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu_torch.ops import flow as tflow
from torch_port_support import computed_at_once, one_torch_thread  # noqa: F401  (autouse)

GOLDENS = Path(__file__).parent / "goldens"
# Whole-frame fraction of the natural 240x320 golden within +-2 that the
# per-op path reaches on the CPU (0.994369, with XLA:CPU's fused
# multiply-adds), less 0.1 %. The solve diverges along the border of that
# periodic texture, where any rounding difference grows: the JAX package's
# own XLA path reaches 0.998209 compiled as one program and 0.994887
# compiled level by level (tests/flow_natural_parity.py; ROADMAP.md queue 3).
NATURAL_WHOLE_FRAME_PM2 = 0.99336


def _jax_params(**kw):
    return jflow.FlowParams(backend="xla", warp="gather", fuse_level="off", **kw)


def _sinusoid_kw(n_inner):
    return dict(n_outer=3, n_sor=10, min_width=16, n_inner=n_inner)


@pytest.fixture(scope="module")
def flows():
    """The module's largest video flows, computed once and at once
    (``computed_at_once``): the per-op path's 240x320 flows of the sinusoid
    and the natural frames, which the golden tests compare, and the JAX
    package's per-op video flow of the 56x72 sinusoid with one and two
    inners, which test_video_flow_per_op_matches_jax compares."""
    p = tflow.FlowParams(fuse_level="off")
    small = make_frames(seed=3, t=4, h=56, w=72)
    return computed_at_once({
        "flow_240x320": lambda: tflow.video_flow_uint8(
            torch.from_numpy(make_frames()), p).numpy(),
        "natural": lambda: tflow.video_flow_uint8(
            torch.from_numpy(make_natural_frames()), p).numpy(),
        **{f"jax_sinusoid_{n}": (lambda n=n: np.asarray(jflow.video_flow_uint8(
            jnp.asarray(small), _jax_params(**_sinusoid_kw(n))))) for n in (1, 2)},
    })


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("init", ["zero", "random"])
@pytest.mark.parametrize("n_inner", [1, 2])
def test_per_op_level_matches_jax(n_inner, init, backend):
    b, h, w = 2, 40, 48
    im1, im2 = _pairs(b, h, w, seed=5)
    rng = np.random.RandomState(1)
    if init == "zero":
        u = np.zeros((b, h, w), np.float32)
        v = np.zeros_like(u)
    else:
        u = ((rng.rand(b, h, w) - 0.5) * 4.0).astype(np.float32)
        v = ((rng.rand(b, h, w) - 0.5) * 4.0).astype(np.float32)
    jp = jflow.FlowParams(n_outer=2, n_sor=8, n_inner=n_inner, backend=backend,
                          warp="gather", fuse_level="off")
    ju, jv = jflow._flow_level(*map(jnp.asarray, (im1, im2, u, v)), jp)
    tp = tflow.FlowParams(n_outer=2, n_sor=8, n_inner=n_inner, fuse_level="off")
    tu, tv = tflow._flow_level_per_op(*map(torch.from_numpy, (im1, im2, u, v)), tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("route", [dict(fuse_level="off"),
                                   dict(n_inner=2),
                                   dict(n_inner=2, fuse_level="on")])
def test_coarse2fine_per_op_matches_jax(route):
    im1, im2 = _pairs(2, 40, 48, seed=7)
    kw = dict(n_outer=2, n_sor=10, min_width=16)
    jp = _jax_params(n_inner=route.get("n_inner", 1), **kw)
    ju, jv = jflow.coarse2fine_flow(jnp.asarray(im1), jnp.asarray(im2), jp)
    tu, tv = tflow.coarse2fine_flow(torch.from_numpy(im1), torch.from_numpy(im2),
                                    tflow.FlowParams(**route, **kw))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("n_inner", [1, 2])
def test_video_flow_per_op_matches_jax(n_inner, flows):
    """On the sinusoid frames: the natural-statistics texture at this size
    drives both solvers to flows of 40 px on a 48x64 frame, where 1-ulp
    differences grow without bound."""
    frames = make_frames(seed=3, t=4, h=56, w=72)
    want = flows[f"jax_sinusoid_{n_inner}"]
    got = tflow.video_flow_uint8(torch.from_numpy(frames),
                                 tflow.FlowParams(fuse_level="off",
                                                  **_sinusoid_kw(n_inner))).numpy()
    assert got.shape == want.shape == (4, 56, 72, 3) and got.dtype == np.uint8
    _uint8_within(got, want, 0.999, 1)


@pytest.mark.parametrize("golden,frames,params", [
    ("flow_240x320", make_frames, {}),
    ("flow_natural_96x128", lambda: make_natural_frames(h=96, w=128), SMALL_PARAMS),
])
def test_video_flow_per_op_matches_golden(golden, frames, params, flows):
    """The goldens' own path and parameters, at their tests' +-1 / 99.9 %
    bar (tests/test_flow_golden.py:55,123)."""
    want = np.load(GOLDENS / f"{golden}.npz")["flow_images"]
    if golden in flows:
        got = flows[golden]
    else:
        got = tflow.video_flow_uint8(torch.from_numpy(frames()),
                                     tflow.FlowParams(fuse_level="off", **params)).numpy()
    assert got.shape == want.shape
    _uint8_within(got, want, 0.999, 1)


def test_video_flow_per_op_natural_240x320_golden(flows):
    """The natural-statistics golden at its test's bar, +-2 on >= 99.5 %
    (tests/test_flow_golden.py:114), beyond 8 px of the border; over the
    whole frame at the fraction the per-op path reaches, less 0.1 %."""
    want = np.load(GOLDENS / "flow_natural_240x320.npz")["flow_images"]
    got = flows["natural"]
    assert got.shape == want.shape == (3, 240, 320, 3)
    inner = _border_distance(240, 320) >= 8
    _uint8_within(got[:, inner], want[:, inner], 0.995, 2)
    _uint8_within(got, want, NATURAL_WHOLE_FRAME_PM2, 2)


def _flow_images(t, seed, ties=False):
    rng = np.random.RandomState(seed)
    f = rng.randint(0, 256, (t, 6, 7, 3)).astype(np.uint8)
    if ties:
        f[1::3] = f[0]  # runs of equal energies
        f[-2:] = f[0]
    return f


@pytest.mark.parametrize("t,keep,min_keep,ties", [
    (20, 0.3, 8, False), (20, 0.3, 8, True), (40, 0.3, 8, True),
    (5, 0.3, 8, False), (9, 0.5, 2, True), (12, 0.0, 0, False)])
def test_flow_energy_filter_matches_jax(t, keep, min_keep, ties):
    f = _flow_images(t, seed=t, ties=ties)
    jidx, jen = jflow.flow_energy_filter(jnp.asarray(f), keep, min_keep)
    idx, en = tflow.flow_energy_filter(torch.from_numpy(f), keep, min_keep)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(en.numpy(), np.asarray(jen), atol=1e-5)


def test_fuse_level_rejects_unknown_values():
    im = torch.zeros((1, 24, 24, 3))
    for kw in (dict(fuse_level="interpret"), dict(fuse_level="off ", n_inner=2),
               dict(fuse_level=None)):
        with pytest.raises(ValueError, match="fuse_level"):
            tflow.coarse2fine_flow(im, im, tflow.FlowParams(**kw))


@pytest.mark.parametrize("kw,path", [
    (dict(), "fused"), (dict(fuse_level="on"), "fused"),
    (dict(fuse_level="off"), "per-op"), (dict(n_inner=2), "per-op"),
    (dict(n_inner=2, fuse_level="on"), "per-op"),
    (dict(n_inner=3, fuse_level="off"), "per-op")])
def test_dispatch_calls_one_path(monkeypatch, kw, path):
    """The fused level calls only K1's wrapper, the per-op level only K4's,
    K5's and the IRLS coefficients'; a call of a wrapper on a CUDA tensor is
    a launch."""
    calls = {"flow_level": 0, "sor_solve": 0, "warp_bilinear": 0, "irls_coefficients": 0}

    def counting(name):
        real = getattr(tflow, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(tflow, name, counting(name))
    im1, im2 = _pairs(1, 24, 28, seed=3)
    p = tflow.FlowParams(n_outer=2, n_sor=2, min_width=16, **kw)
    tflow.coarse2fine_flow(torch.from_numpy(im1), torch.from_numpy(im2), p)
    levels = len(tflow._pyramid_shapes(24, 28, p.ratio, p.min_width))
    if path == "fused":
        assert calls == {"flow_level": levels, "sor_solve": 0, "warp_bilinear": 0,
                         "irls_coefficients": 0}
    else:
        assert calls == {"flow_level": 0, "sor_solve": levels * 2 * p.n_inner,
                         "warp_bilinear": levels * 2,
                         "irls_coefficients": levels * 2 * p.n_inner}
