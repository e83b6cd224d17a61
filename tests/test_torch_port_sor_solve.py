"""SOR-solve parity of the PyTorch port against the JAX package (CPU).

The port's plain K4 (``sor_solve_reference``, what ``sor_solve`` runs on
CPU tensors) against the Pallas ``sor_solve_pallas(..., interpret=True)`` on
random normal equations with a coupling a12, symmetric edge weights that are
zero across the border, odd and even sweep counts, and cold and warm starts;
and the closed form of a decoupled system. Its parity with the JAX XLA loop
is held through the per-op flow level (tests/test_torch_port_flow_per_op.py).
Inputs are made with numpy from seeds and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.ops.pallas_flow import sor_solve_pallas
from video_classification_tpu_torch.ops.sor_solve import (
    sor_solve, sor_solve_reference)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _edge_weights(phi):
    """Half-point weights of phi (B, H, W), zero across the border."""
    p = np.pad(phi, ((0, 0), (1, 1), (1, 1)), mode="edge")
    up = 0.5 * (phi + p[:, :-2, 1:-1])
    down = 0.5 * (phi + p[:, 2:, 1:-1])
    left = 0.5 * (phi + p[:, 1:-1, :-2])
    right = 0.5 * (phi + p[:, 1:-1, 2:])
    up[:, 0] = 0
    down[:, -1] = 0
    left[:, :, 0] = 0
    right[:, :, -1] = 0
    return up, down, left, right


def _system(b, h, w, seed, warm):
    rng = np.random.RandomState(seed)

    def f(*shape):
        return rng.rand(*shape).astype(np.float32)

    a11 = 0.5 + f(b, h, w)
    a22 = 0.5 + f(b, h, w)
    a12 = (f(b, h, w) - 0.5) * 0.6
    b1 = rng.randn(b, h, w).astype(np.float32)
    b2 = rng.randn(b, h, w).astype(np.float32)
    weights = _edge_weights(0.2 + 2.0 * f(b, h, w))
    u = (f(b, h, w) - 0.5) * 6.0
    v = (f(b, h, w) - 0.5) * 6.0
    if warm:
        du0 = (f(b, h, w) - 0.5) * 0.5
        dv0 = (f(b, h, w) - 0.5) * 0.5
    else:
        du0 = dv0 = np.zeros((b, h, w), np.float32)
    return (a11, a12, a22, b1, b2) + tuple(w_.astype(np.float32) for w_ in weights) \
        + (u, v, du0, dv0)


@pytest.mark.parametrize("alpha", [0.012, 0.3])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("n_sor", [8, 9])
def test_sor_solve_matches_pallas_interpret(n_sor, warm, alpha):
    arrays = _system(2, 16, 24, seed=n_sor + 10 * warm, warm=warm)
    omega = 1.8
    jdu, jdv = sor_solve_pallas(*map(jnp.asarray, arrays[:11]), n_sor, alpha,
                                omega, True, du0=jnp.asarray(arrays[11]),
                                dv0=jnp.asarray(arrays[12]))
    t = [torch.from_numpy(a) for a in arrays]
    du, dv = sor_solve(*t[:11], n_sor, alpha, omega, t[11], t[12])
    assert du.dtype == dv.dtype == torch.float32
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=1e-5)


def test_sor_solve_odd_count_is_the_same_half_sweeps():
    """n_sor sweeps from a warm start equal n_sor - 1 sweeps continued by one
    more from their result: Pallas's double trips plus a remainder are the
    same sequence of half-sweeps."""
    t = [torch.from_numpy(a) for a in _system(1, 12, 13, seed=3, warm=True)]
    du9, dv9 = sor_solve_reference(*t[:11], 9, 0.012, 1.8, t[11], t[12])
    du8, dv8 = sor_solve_reference(*t[:11], 8, 0.012, 1.8, t[11], t[12])
    du, dv = sor_solve_reference(*t[:11], 1, 0.012, 1.8, du8, dv8)
    assert torch.equal(du, du9) and torch.equal(dv, dv9)


def test_sor_solve_decoupled_closed_form():
    """No smoothness coupling (all weights 0) and a12 = 0: with omega 1 one
    sweep gives du = b1 / a11, dv = b2 / a22 (tests/test_pallas_flow.py's
    case), and the Pallas kernel agrees."""
    rng = np.random.RandomState(1)
    b, h, w = 2, 16, 24
    a11 = (1.0 + rng.rand(b, h, w)).astype(np.float32)
    a22 = (1.0 + rng.rand(b, h, w)).astype(np.float32)
    b1 = rng.randn(b, h, w).astype(np.float32)
    b2 = rng.randn(b, h, w).astype(np.float32)
    z = np.zeros((b, h, w), np.float32)
    arrays = (a11, z, a22, b1, b2, z, z, z, z, z, z)
    du, dv = sor_solve(*map(torch.from_numpy, arrays), 8, 0.012, 1.0)
    np.testing.assert_allclose(du.numpy(), b1 / a11, atol=1e-4)
    np.testing.assert_allclose(dv.numpy(), b2 / a22, atol=1e-4)
    jdu, jdv = sor_solve_pallas(*map(jnp.asarray, arrays), 8, 0.012, 1.0, True)
    np.testing.assert_allclose(du.numpy(), np.asarray(jdu), atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), atol=1e-5)


def test_sor_solve_checks_its_inputs():
    t = [torch.from_numpy(a) for a in _system(1, 6, 7, seed=0, warm=False)]
    with pytest.raises(ValueError):
        sor_solve(t[0][:, :5], *t[1:11], 2, 0.012, 1.8)
    with pytest.raises(TypeError):
        sor_solve(t[0].double(), *t[1:11], 2, 0.012, 1.8)
