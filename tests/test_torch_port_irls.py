"""The per-op inner's IRLS coefficients of the PyTorch port (CPU).

``ops/irls.irls_coefficients`` is one CUDA kernel on the card; on CPU tensors
it runs its plain version. Held here:

  * the wrapper on CPU tensors against the plain ``_outer_terms`` +
    ``_normal_equations`` of ``ops/flow.py``, bit for bit: one inner (the
    warp's one order) and two (K5's both orders), from zero and from a
    nonzero warm start, at odd shapes with H or W of 2 or 3;
  * the wrapper against the JAX package's per-op level (``_flow_level``'s
    code, ``tests/flow_natural_parity._jax_outer``) given XLA:CPU's psi and
    phi, bit for bit;
  * ``_flow_level_per_op`` on CPU tensors against the same loop written out
    here from ``warp_bilinear``, ``_outer_terms``, ``_normal_equations`` and
    ``sor_solve_reference``, bit for bit;
  * the wrapper's checks of dtype, shape, device and layout, and a tensor off
    the CPU (``meta`` here) going to ``utils/cuda.build()``, which raises
    without nvcc, instead of to the plain version.
Inputs are made with numpy from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_natural_parity import _jax_outer
from test_torch_port_flow import _pairs
from video_classification_tpu_torch.ops import flow as tflow
from video_classification_tpu_torch.ops import irls
from video_classification_tpu_torch.ops.irls import irls_coefficients
from video_classification_tpu_torch.ops.sor_solve import sor_solve_reference
from video_classification_tpu_torch.ops.warp import warp_bilinear
from video_classification_tpu_torch.utils import cuda
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

EPS = tflow.FlowParams().eps


def _inputs(b, h, w, c, seed, warm):
    """im1, im2 (B, H, W, C) in [0, 1], a flow (u, v) of a few px and the
    increments (du, dv): zero, or a nonzero warm start."""
    rng = np.random.RandomState(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy(((rng.rand(*shape) - 0.5) * scale).astype(np.float32))

    im1, im2 = f(b, h, w, c) + 0.5, f(b, h, w, c) + 0.5
    u, v = f(b, h, w, scale=4.0), f(b, h, w, scale=4.0)
    du, dv = (f(b, h, w, scale=0.6) if warm else torch.zeros((b, h, w))
              for _ in range(2))
    return im1, im2, u, v, du, dv


def _assert_bit_equal(got, want):
    assert len(got) == len(want) == len(irls.FIELDS)
    for name, g, w in zip(irls.FIELDS, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: max diff {float((g - w).abs().max())}"


@pytest.mark.parametrize("start", ["zero", "warm"])
@pytest.mark.parametrize("n_inner", [1, 2])
@pytest.mark.parametrize("shape", [(2, 24, 32, 3), (1, 2, 7, 3), (2, 3, 5, 3),
                                   (1, 9, 2, 2), (1, 2, 3, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wrapper_is_the_plain_outer_terms_and_normal_equations(shape, n_inner, start):
    im1, im2, u, v, du, dv = _inputs(*shape, seed=sum(shape) + n_inner, warm=start == "warm")
    warped, warped_grad = tflow._warps(im2, u, v, n_inner)
    assert (warped_grad is warped) == (n_inner == 1)
    got = irls_coefficients(im1, warped, warped_grad, u, v, du, dv, EPS)
    want = tflow._normal_equations(*tflow._outer_terms(im1, im2, u, v, n_inner),
                                   u, v, du, dv, EPS)
    _assert_bit_equal(got, want)
    assert irls_coefficients.launches == 0


def test_both_warp_orders_reach_the_coefficients():
    """With two inners the gradients take K5's other order, which differs
    from the first on some pixels, and so do the coefficients."""
    im1, im2, u, v, du, dv = _inputs(2, 24, 32, 3, seed=1, warm=True)
    warped, warped_grad = tflow._warps(im2, u, v, 2)
    assert not torch.equal(warped, warped_grad)
    one = irls_coefficients(im1, warped, warped, u, v, du, dv, EPS)
    two = irls_coefficients(im1, warped, warped_grad, u, v, du, dv, EPS)
    assert any(not torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("hw", [(24, 32), (43, 57)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_wrapper_matches_the_jax_per_op_level(hw):
    """The JAX package's coefficients of one outer (``_flow_level``'s code)
    given XLA:CPU's psi and phi: the port's wrapper with the same psi and phi,
    bit-equal."""
    im1, im2 = _pairs(2, *hw, seed=hw[0])
    rng = np.random.RandomState(hw[1])
    u, v = (((rng.rand(2, *hw) - 0.5) * 4).astype(np.float32) for _ in range(2))
    _, _, jpsi, jphi, jco = _jax_outer(*map(jnp.asarray, (im1, im2, u, v)))
    ta, tb, tu, tv = map(torch.from_numpy, (im1, im2, u, v))
    given = iter([torch.from_numpy(np.array(jpsi)), torch.from_numpy(np.array(jphi))])
    z = torch.zeros_like(tu)
    warped = warp_bilinear(tb, tu, tv)
    got = irls_coefficients(ta, warped, warped, tu, tv, z, z, EPS,
                            rsqrt=lambda _x: next(given))
    _assert_bit_equal(got, [torch.from_numpy(np.array(c)) for c in jco])


@pytest.mark.parametrize("n_inner", [1, 2, 3])
def test_per_op_level_is_the_written_out_loop(n_inner):
    im1, im2, u, v, _, _ = _inputs(2, 20, 28, 3, seed=7 + n_inner, warm=False)
    p = tflow.FlowParams(n_outer=2, n_sor=6, n_inner=n_inner, fuse_level="off")
    got = tflow._flow_level_per_op(im1, im2, u, v, p)
    wu, wv = u, v
    for _outer in range(p.n_outer):
        terms = tflow._outer_terms(im1, im2, wu, wv, n_inner)
        du, dv = torch.zeros_like(wu), torch.zeros_like(wv)
        for _inner in range(n_inner):
            coeffs = tflow._normal_equations(*terms, wu, wv, du, dv, p.eps)
            du, dv = sor_solve_reference(*coeffs, wu, wv, p.n_sor, p.alpha, p.omega,
                                         du, dv)
        wu, wv = wu + du, wv + dv
    assert torch.equal(got[0], wu) and torch.equal(got[1], wv)
    assert float((got[0] - u).abs().max()) > 0


def test_wrapper_checks_its_inputs():
    im1, im2, u, v, du, dv = _inputs(1, 6, 7, 3, seed=0, warm=True)
    args = [im1, im2, im2, u, v, du, dv]

    def call(i, t):
        return irls_coefficients(*args[:i], t, *args[i + 1:], EPS)

    with pytest.raises(TypeError, match="float32"):
        call(0, im1.double())
    with pytest.raises(TypeError, match="float32"):
        call(6, dv.half())
    with pytest.raises(ValueError, match="warped_grad"):
        call(2, im2[:, :5].contiguous())
    with pytest.raises(ValueError, match="du"):
        call(5, du[:, :, :6].contiguous())
    with pytest.raises(ValueError, match="im1"):
        call(0, im1[0])
    with pytest.raises(ValueError, match="contiguous"):
        call(1, im2.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        call(3, u.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="meta"):
        call(4, v.to("meta"))


def test_a_tensor_off_the_cpu_goes_to_the_kernel(monkeypatch):
    """A meta tensor is not a CPU tensor: the wrapper builds the kernels,
    which raises here (no nvcc), and never runs the plain version."""
    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    built = []
    real_build = cuda.build

    def build():
        built.append(True)
        return real_build()

    monkeypatch.setattr(irls, "irls_coefficients_reference", refuse)
    monkeypatch.setattr(cuda, "build", build)
    meta = [t.to("meta") for t in _inputs(1, 6, 7, 3, seed=0, warm=True)]
    with pytest.raises(Exception) as raised:
        irls_coefficients(meta[0], meta[1], meta[1], *meta[2:], EPS)
    assert built and not isinstance(raised.value, AssertionError)
    assert irls_coefficients.launches == 0
    with pytest.raises(ValueError, match="rsqrt"):
        irls_coefficients(meta[0], meta[1], meta[1], *meta[2:], EPS,
                          rsqrt=lambda x: x)
