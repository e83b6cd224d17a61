"""Warp parity of the PyTorch port against the JAX package (CPU).

The port's plain K5 (``warp_bilinear_reference``, what ``warp_bilinear``
runs on CPU tensors) against JAX ``_warp_bilinear`` for flows within, at and
far past the Pallas kernel's radius, integer flows and flows that cross the
border; against ``warp_select_shift_pallas(..., interpret=True)`` for
in-range flows; and against ``_warp`` with the interpreted kernel across
every tier of its radius cascade and past it (the gather fallback), as
tests/test_pallas_flow.py does for the JAX package. The bar is 1e-6
absolute, no relative slack: the operations and their order are the same.
Inputs are made with numpy from seeds and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.ops.flow import FlowParams, _warp, _warp_bilinear
from video_classification_tpu.ops.pallas_flow import warp_select_shift_pallas
from video_classification_tpu_torch.ops.warp import warp_bilinear
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _case(b=2, h=24, w=40, c=3, seed=0, scale=3.0):
    rng = np.random.RandomState(seed)
    im = rng.rand(b, h, w, c).astype(np.float32)
    u = ((rng.rand(b, h, w) - 0.5) * 2 * scale).astype(np.float32)
    v = ((rng.rand(b, h, w) - 0.5) * 2 * scale).astype(np.float32)
    return im, u, v


def _port(im, u, v):
    return warp_bilinear(torch.from_numpy(im), torch.from_numpy(u),
                         torch.from_numpy(v)).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("scale", [0.7, 3.0, 8.0, 30.0, 250.0])
@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (1, 7, 5, 2), (3, 2, 2, 1)])
def test_warp_matches_gather(scale, shape):
    im, u, v = _case(*shape, seed=int(scale), scale=scale)
    _close(_port(im, u, v), np.asarray(_warp_bilinear(*map(jnp.asarray, (im, u, v)))))


def test_warp_integer_and_border_flows():
    """Integer displacements (weights 0 and 1), flows onto and past the last
    row and column (the base-corner clamp) and past the first."""
    b, h, w, c = 1, 16, 32, 2
    im = np.random.RandomState(3).rand(b, h, w, c).astype(np.float32)
    u = np.full((b, h, w), 3.0, np.float32)
    u[:, :4] = -2.0
    v = np.full((b, h, w), 3.0, np.float32)
    v[:, :, :6] = -2.0
    # within the kernel's radius 3 (tests/test_pallas_flow.py's case)
    _close(_port(im, u, v), np.asarray(
        warp_select_shift_pallas(*map(jnp.asarray, (im, u, v)), 3, interpret=True)))
    u[:, 10:, 20:] = 40.0
    v[:, 12:] = np.arange(h - 12, dtype=np.float32)[None, ::-1, None] - 1.0
    _close(_port(im, u, v), np.asarray(_warp_bilinear(*map(jnp.asarray, (im, u, v)))))
    # the flow (w-1-x, h-1-y) samples the last pixel exactly
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    got = _port(im, (w - 1 - xx)[None], (h - 1 - yy)[None])
    np.testing.assert_array_equal(got, np.broadcast_to(im[:, -1:, -1:], got.shape))


def test_warp_matches_select_shift_kernel_in_range():
    im, u, v = _case(seed=11, scale=4.0)
    _close(_port(im, u, v), np.asarray(
        warp_select_shift_pallas(*map(jnp.asarray, (im, u, v)), 4, interpret=True)))


def test_warp_matches_every_cascade_tier():
    """The JAX package's dispatch: tier 2, tier 5, the radius 8, and past it
    the gather. The port's one kernel equals each."""
    p = FlowParams(warp="shift_interpret", warp_radius=8, warp_tiers=(2, 5))
    im, u, v = _case(seed=9, scale=1.0)
    warp = jax.jit(lambda *a: _warp(*a, p))
    for scale in (1.5, 4.0, 7.0, 30.0):
        us, vs = u * scale, v * scale
        _close(_port(im, us, vs), np.asarray(warp(*map(jnp.asarray, (im, us, vs)))))


def test_warp_checks_its_inputs():
    im, u, v = (torch.from_numpy(a) for a in _case(1, 4, 5, 3))
    with pytest.raises(ValueError):
        warp_bilinear(im, u[:, :3], v)
    with pytest.raises(ValueError):
        warp_bilinear(im[:, :1], u[:, :1], v[:, :1])
    with pytest.raises(TypeError):
        warp_bilinear(im.double(), u, v)
