"""The port's RAFT (``models/raft.py``) against the JAX package's, piece by
piece and whole (CPU, float32).

One JAX RAFT's variables (shapes from ``eval_shape`` of its init at 64x96,
numpy-seeded by ``randomised_variables``) are carried into the port by
``models/convert.raft_state_dict_from_jax``; every piece below runs the
same submodule's weights in both packages:

  * ``InstanceNorm`` (biased variance, eps 1e-5, no affine);
  * ``ResidualUnit`` with instance norm (with and without the projection)
    and with batch norm on its running statistics (the context encoder);
  * both encoders;
  * ``correlation_pyramid`` at 8x12 (four levels) and 4x6 (three: the
    early stop before a 1x1 level is pooled), float32 divided by sqrt(C);
  * ``lookup``: coordinates inside, at W_l - 1 and H_l - 1, on integers
    and far outside (the clamp), with levels of size 1;
  * ``MotionEncoder``, ``SepConvGRU``, ``convex_upsample`` ((8, 8, 9)
    mask, zero padding);
  * the whole RAFT at 32x48 with 12 iterations (its pyramid stops at three
    levels, so the motion encoder takes 243 channels: both packages' init
    give that shape) and at 64x96 with 3 iterations.

Bar: atol = rtol = 5e-3 (the port's float32 network bar); the pieces are
held at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.models import raft as jr
from video_classification_tpu_torch.models import raft as pr
from video_classification_tpu_torch.models.convert import raft_state_dict_from_jax
from torch_port_support import one_torch_thread, randomised_variables  # noqa: F401

PIECE_TOL = 1e-4


def _images(seed, n, h, w):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, h, w, 3).astype(np.float32)
    b = np.clip(np.roll(a, (1, 2), axis=(1, 2)) + rng.normal(0, 0.02, a.shape), 0, 1)
    return a, b.astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def carried():
    """(JAX variables of a 64x96 RAFT, the port's RAFT on them)."""
    a, b = _images(0, 1, 64, 96)
    shapes = jax.eval_shape(lambda: jr.RAFT(num_iters=1).init(
        jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b)))
    variables = randomised_variables(shapes, seed=5)
    model = pr.RAFT(num_iters=3)
    model.load_state_dict(raft_state_dict_from_jax(variables))
    return variables, model.eval()


def _sub(variables, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables.get(coll, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[coll] = node
    return out


def test_instance_norm_matches_jax():
    x = np.random.RandomState(1).normal(3.0, 2.0, (2, 7, 9, 5)).astype(np.float32)
    want = np.asarray(jr.InstanceNorm().apply({}, jnp.asarray(x)))
    got = _nhwc(pr.InstanceNorm()(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)
    assert list(pr.InstanceNorm().state_dict()) == []  # no affine, no statistics


@pytest.mark.parametrize("enc,res,norm,cin", [("fnet", "res2", "instance", 64),
                                              ("fnet", "res1", "instance", 64),
                                              ("cnet", "res4", "batch", 96)])
def test_residual_unit_matches_jax(carried, enc, res, norm, cin):
    variables, model = carried
    idx = int(res[3:])
    cout, stride = pr.BLOCKS[idx][1], pr.BLOCKS[idx][2]
    x = np.random.RandomState(idx).normal(size=(2, 12, 16, cin)).astype(np.float32)
    unit = jr.ResidualUnit(cout, stride, norm=norm)
    want = np.asarray(unit.apply(_sub(variables, enc, res), jnp.asarray(x), False))
    port_enc = model.feature_encoder if enc == "fnet" else model.context_encoder
    block = getattr(port_enc, f"layer{idx // 2 + 1}")[idx % 2]
    assert (block.downsample is None) == (stride == 1 and cin == cout)
    with torch.no_grad():
        got = _nhwc(block(_nchw(x)))
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("enc,norm", [("fnet", "instance"), ("cnet", "batch")])
def test_encoders_match_jax(carried, enc, norm):
    variables, model = carried
    a, _ = _images(2, 2, 64, 96)
    x = 2.0 * a - 1.0
    want = np.asarray(jr.RAFTEncoder(256, norm=norm).apply(_sub(variables, enc),
                                                           jnp.asarray(x), False))
    port_enc = model.feature_encoder if enc == "fnet" else model.context_encoder
    with torch.no_grad():
        got = _nhwc(port_enc(_nchw(x)))
    assert got.shape == (2, 8, 12, 256)
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("h,w,levels", [(8, 12, 4), (4, 6, 3)])
def test_correlation_pyramid_matches_jax(h, w, levels):
    rng = np.random.RandomState(h)
    f1, f2 = (rng.normal(size=(2, h, w, 16)).astype(np.float32) for _ in range(2))
    want = jr.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = pr.correlation_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 4)
    assert len(got) == len(want) == levels == pr.pyramid_levels(8 * h, 8 * w)
    for g, wnt in zip(got, want):
        assert tuple(g.shape) == wnt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=PIECE_TOL,
                                   rtol=PIECE_TOL)


def test_lookup_matches_jax_inside_at_the_edge_and_past_it():
    rng = np.random.RandomState(7)
    f1, f2 = (rng.normal(size=(2, 4, 6, 8)).astype(np.float32) for _ in range(2))
    pyramid = [np.array(p) for p in jr.correlation_pyramid(jnp.asarray(f1),
                                                             jnp.asarray(f2), 4)]
    assert [p.shape[3:] for p in pyramid] == [(4, 6), (2, 3), (1, 1)]  # a 1x1 level
    ys, xs = np.mgrid[0:4, 0:6].astype(np.float32)
    grid = np.stack([xs, ys], -1)[None].repeat(2, 0)
    coords = {
        "inside": grid + rng.uniform(-0.9, 0.9, grid.shape).astype(np.float32),
        "integers": grid + rng.randint(-2, 3, grid.shape).astype(np.float32),
        "at the last column and row": np.stack([np.full((2, 4, 6), 5.0, np.float32),
                                                np.full((2, 4, 6), 3.0, np.float32)], -1),
        "far outside": rng.uniform(-40, 40, grid.shape).astype(np.float32),
    }
    for name, c in coords.items():
        want = np.asarray(jr.lookup([jnp.asarray(p) for p in pyramid], jnp.asarray(c), 4))
        got = pr.lookup([torch.from_numpy(p) for p in pyramid], torch.from_numpy(c), 4)
        assert got.shape == (2, 4, 6, 3 * 81)
        np.testing.assert_allclose(got.numpy(), want, atol=PIECE_TOL, rtol=PIECE_TOL,
                                   err_msg=name)


def test_motion_encoder_and_gru_match_jax(carried):
    variables, model = carried
    rng = np.random.RandomState(9)
    flow = rng.normal(0, 3, (2, 8, 12, 2)).astype(np.float32)
    corr = rng.normal(size=(2, 8, 12, 324)).astype(np.float32)
    want = np.asarray(jr.MotionEncoder().apply(_sub(variables, "update_block", "encoder"),
                                               jnp.asarray(flow), jnp.asarray(corr)))
    with torch.no_grad():
        got = _nhwc(model.update_block.motion_encoder(_nchw(flow), _nchw(corr)))
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)
    np.testing.assert_array_equal(got[..., -2:], flow)  # the flow rides along

    h = np.tanh(rng.normal(size=(2, 8, 12, 128))).astype(np.float32)
    x = rng.normal(size=(2, 8, 12, 256)).astype(np.float32)
    want = np.asarray(jr.SepConvGRU().apply(_sub(variables, "update_block", "gru"),
                                            jnp.asarray(h), jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(model.update_block.recurrent_block(_nchw(h), _nchw(x)))
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(11)
    flow = rng.normal(0, 2, (2, 3, 5, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 3, 5, 576)).astype(np.float32)
    want = np.asarray(jr.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = pr.convex_upsample(torch.from_numpy(flow), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 24, 40, 2)
    np.testing.assert_allclose(got, want, atol=PIECE_TOL, rtol=PIECE_TOL)


@pytest.mark.parametrize("h,w,iters", [(32, 48, 12), (64, 96, 3)])
def test_raft_matches_jax(h, w, iters):
    a, b = _images(h, 2, h, w)
    jax_model = jr.RAFT(num_iters=iters)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), jnp.asarray(a),
                                                   jnp.asarray(b)))
    variables = randomised_variables(shapes, seed=h)
    want_up, want_coarse = (np.asarray(t) for t in jax_model.apply(
        variables, jnp.asarray(a), jnp.asarray(b)))
    model = pr.RAFT(num_iters=iters, corr_levels=pr.pyramid_levels(h, w))
    model.load_state_dict(raft_state_dict_from_jax(variables))
    with torch.no_grad():
        up, coarse = model.eval()(torch.from_numpy(a), torch.from_numpy(b))
    assert up.shape == (2, h, w, 2) and coarse.shape == (2, h // 8, w // 8, 2)
    assert float(np.abs(want_up).max()) > 1.0  # the flow moved
    np.testing.assert_allclose(up.numpy(), want_up, atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(coarse.numpy(), want_coarse, atol=5e-3, rtol=5e-3)
