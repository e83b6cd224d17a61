"""Flow parity of the PyTorch port against the JAX package (CPU).

  * the port's plain K1 (``flow_level_reference``, what ``flow_level`` runs
    on CPU tensors) against the Pallas fused-level kernel run with
    ``interpret=True``, at a non-tile-aligned shape, with and without the
    per-pair early exit;
  * the pyramid pieces (blur, antialiased bilinear down- and upsampling)
    against the JAX functions;
  * the port's ``coarse2fine_flow`` at tol 0 against the JAX XLA path, and
    ``video_flow_uint8`` against the checked-in flow goldens, and on the
    natural 240x320 frames against the interpreted Pallas fused-level path.
Inputs are made with numpy from seeds and handed to both.
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_flow_golden import make_frames, make_natural_frames
from video_classification_tpu.ops import flow as jflow
from video_classification_tpu.ops.pallas_flow import flow_level_fused_pallas
from video_classification_tpu_torch.ops import flow as tflow
from video_classification_tpu_torch.ops.flow_level import (
    flow_level, flow_level_reference)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

GOLDENS = Path(__file__).parent / "goldens"


def _pairs(b, h, w, seed):
    """(B, H, W, 3) smooth images and their subpixel-shifted copies."""
    rng = np.random.RandomState(seed)
    im1, im2 = [], []
    for i in range(b):
        base = cv2.GaussianBlur(rng.rand(h, w, 3).astype(np.float32), (0, 0), 2.0)
        m = np.float32([[1, 0, 1.5 - 0.7 * i], [0, 1, -1.0 + 0.4 * i]])
        im1.append(base)
        im2.append(cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT))
    return np.stack(im1), np.stack(im2)


def _uint8_within(got, want, frac, tol):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    within = float((diff <= tol).mean())
    assert within >= frac, (within, int(diff.max()))


@pytest.mark.parametrize("tol", [0.005, 0.0])
@pytest.mark.parametrize("init", ["zero", "random"])
def test_flow_level_matches_pallas_interpret(tol, init):
    b, h, w = 2, 20, 28
    im1, im2 = _pairs(b, h, w, seed=0)
    rng = np.random.RandomState(1)
    if init == "zero":
        u = np.zeros((b, h, w), np.float32)
        v = np.zeros_like(u)
    else:
        u = ((rng.rand(b, h, w) - 0.5) * 4.0).astype(np.float32)
        v = ((rng.rand(b, h, w) - 0.5) * 4.0).astype(np.float32)
    p = jflow.FlowParams(n_outer=3, n_sor=10, fuse_level="interpret",
                         fuse_outer_tol=tol)
    ju, jv, jmx = flow_level_fused_pallas(
        jnp.asarray(im1), jnp.asarray(im2), jnp.asarray(u), jnp.asarray(v), p,
        interpret=True)
    tu, tv, tmx = flow_level(
        torch.from_numpy(im1), torch.from_numpy(im2), torch.from_numpy(u),
        torch.from_numpy(v), p.n_outer, p.n_sor, p.alpha, p.omega, p.eps,
        p.warp_radius, tol)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tmx.numpy(), np.asarray(jmx), atol=1e-5)


def test_flow_level_early_exit_stops_converged_pair():
    """A pair whose first outer moves it by <= tol keeps that outer's result;
    with tol 0 the same pair runs on and ends elsewhere."""
    b, h, w = 2, 20, 28
    im1, im2 = _pairs(b, h, w, seed=2)
    im2[1] = im1[1]  # identical images: the first outer's increment is 0
    args = [torch.from_numpy(im1), torch.from_numpy(im2),
            torch.zeros((b, h, w)), torch.zeros((b, h, w))]
    u1, v1, _ = flow_level_reference(*args, 1, 10, 0.012, 1.8, 1e-6, 8, 0.0)
    u3, v3, _ = flow_level_reference(*args, 3, 10, 0.012, 1.8, 1e-6, 8, 0.005)
    assert torch.equal(u3[1], u1[1]) and float(u3[1].abs().max()) == 0.0
    u0, _, _ = flow_level_reference(*args, 3, 10, 0.012, 1.8, 1e-6, 8, 0.0)
    assert not torch.equal(u0[0], u1[0])


def test_gaussian_blur_matches_jax():
    x = np.random.RandomState(3).rand(2, 17, 23, 3).astype(np.float32)
    want = np.asarray(jflow._gaussian_blur(jnp.asarray(x), 0.6333333))
    got = tflow._gaussian_blur(torch.from_numpy(x), 0.6333333).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((240, 320), (180, 240)),
                                     ((40, 48), (30, 36)),
                                     ((30, 36), (40, 48)),
                                     ((22, 27), (30, 36))])
def test_resize_bilinear_matches_jax(src, dst):
    """Antialiased downsampling (the pyramid) and plain upsampling (the flow
    between levels) both match jax.image.resize(..., 'linear')."""
    x = np.random.RandomState(4).rand(2, *src, 3).astype(np.float32)
    want = np.asarray(jflow._resize_bilinear(jnp.asarray(x), dst))
    got = tflow._resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_pyramid_shapes_match_jax():
    for hw in ((240, 320), (64, 96), (96, 128), (41, 37)):
        for mw in (16, 20):
            assert tflow._pyramid_shapes(*hw, 0.75, mw) == \
                jflow._pyramid_shapes(*hw, 0.75, mw)


def test_coarse2fine_matches_jax_xla_path():
    """Plain K1 at tol 0 inside the port's coarse-to-fine solve == the JAX
    package's per-op XLA path (which always runs every outer)."""
    im1, im2 = _pairs(2, 40, 48, seed=5)
    jp = jflow.FlowParams(n_outer=2, n_sor=10, backend="xla", warp="gather",
                          fuse_level="off")
    ju, jv = jflow.coarse2fine_flow(jnp.asarray(im1), jnp.asarray(im2), jp)
    tp = tflow.FlowParams(n_outer=2, n_sor=10, fuse_outer_tol=0.0)
    tu, tv = tflow.coarse2fine_flow(torch.from_numpy(im1), torch.from_numpy(im2), tp)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    _uint8_within(tflow.encode_flow_uint8(tu, tv).numpy(),
                  np.asarray(jflow.encode_flow_uint8(ju, jv)), 0.999, 1)


def test_encode_flow_uint8_matches_jax():
    rng = np.random.RandomState(6)
    u = ((rng.rand(3, 9, 11) - 0.5) * 14).astype(np.float32)
    v = ((rng.rand(3, 9, 11) - 0.5) * 14).astype(np.float32)
    want = np.asarray(jflow.encode_flow_uint8(jnp.asarray(u), jnp.asarray(v)))
    got = tflow.encode_flow_uint8(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("golden,frames,params", [
    ("flow_natural_96x128", lambda: make_natural_frames(h=96, w=128),
     dict(n_outer=2, n_sor=10, min_width=16)),
    ("flow_240x320", make_frames, {}),
])
def test_video_flow_matches_golden(golden, frames, params):
    """The port's video flow at tol 0 against the checked-in goldens (made by
    the JAX package's XLA path), under the golden test's +-1 / 99.9 % bar."""
    want = np.load(GOLDENS / f"{golden}.npz")["flow_images"]
    got = tflow.video_flow_uint8(
        torch.from_numpy(frames()),
        tflow.FlowParams(fuse_outer_tol=0.0, **params)).numpy()
    assert got.shape == want.shape
    _uint8_within(got, want, 0.999, 1)


def _border_distance(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.minimum(np.minimum(yy, h - 1 - yy), np.minimum(xx, w - 1 - xx))


def test_video_flow_natural_240x320_matches_fused_pallas():
    """The natural-statistics 240x320 golden was made by the XLA path; K1
    keeps the fused-level Pallas kernel's semantics (the +-8 px warp clamp),
    which depart from it where the solve diverges along the border of this
    periodic texture. So the port is held against the interpreted Pallas
    kernel on the same frames (the repo's +-1 / 99.9 % bar away from the
    border), and against the golden at the golden's own bar (+-2 / 99.5 %)
    away from the border and no worse than the Pallas kernel over the whole
    frame."""
    frames = make_natural_frames()
    want = np.load(GOLDENS / "flow_natural_240x320.npz")["flow_images"].astype(np.int32)
    fused = np.asarray(jflow.video_flow_uint8(
        jnp.asarray(frames), jflow.FlowParams(fuse_level="interpret",
                                              fuse_outer_tol=0.0))).astype(np.int32)
    got = tflow.video_flow_uint8(
        torch.from_numpy(frames), tflow.FlowParams(fuse_outer_tol=0.0)).numpy()
    got = got.astype(np.int32)
    assert got.shape == fused.shape == want.shape == (3, 240, 320, 3)
    inner = _border_distance(240, 320) >= 8
    _uint8_within(got[:, inner], fused[:, inner], 0.999, 1)
    _uint8_within(got[:, inner], want[:, inner], 0.995, 2)
    port_frac = float((np.abs(got - want) <= 2).mean())
    fused_frac = float((np.abs(fused - want) <= 2).mean())
    assert port_frac >= fused_frac - 1e-3, (port_frac, fused_frac)
