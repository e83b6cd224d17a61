"""The port's detection primitives against the JAX package's (CPU, float32).

The port's ops are batched over frames and channels-first: feature maps
(B, C, H, W), boxes (B, N, 4), pooled ROIs (B, N, C, S, S); the JAX ones
take one frame channels-last. Inputs come from a numpy seed; atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.detect import ops as jops
from video_classification_tpu.detect.densepose import generate_anchors as jax_anchors
from video_classification_tpu_torch.detect import ops
from video_classification_tpu_torch.detect.densepose import generate_anchors
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5


def _boxes(rng, n, extent):
    p = rng.rand(n, 4) * extent
    return np.stack([np.minimum(p[:, 0], p[:, 2]), np.minimum(p[:, 1], p[:, 3]),
                     np.maximum(p[:, 0], p[:, 2]) + 1, np.maximum(p[:, 1], p[:, 3]) + 1],
                    axis=1).astype(np.float32)


def test_roi_align_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.rand(2, 20, 24, 5).astype(np.float32)       # two frames, HWC
    boxes = np.stack([_boxes(rng, 6, 90.0), _boxes(rng, 6, 90.0)])
    boxes[0, 0] = [-8.0, -6.0, 120.0, 110.0]                # past every border
    got = ops.roi_align(torch.from_numpy(feat).permute(0, 3, 1, 2),
                        torch.from_numpy(boxes), 7, 0.25)
    assert got.shape == (2, 6, 5, 7, 7)
    for f in range(2):
        want = np.asarray(jops.roi_align(jnp.asarray(feat[f]), jnp.asarray(boxes[f]), 7, 0.25))
        np.testing.assert_allclose(got[f].permute(0, 2, 3, 1).numpy(), want, atol=ATOL)


def test_multilevel_roi_align_matches_jax():
    """The four-level case of the JAX package's own test: one box per level."""
    rng = np.random.RandomState(3)
    feats = [rng.rand(1, 32 // 2 ** i, 48 // 2 ** i, 5).astype(np.float32)
             for i in range(4)]
    boxes = np.asarray([[4.0, 4.0, 40.0, 40.0], [0.0, 0.0, 150.0, 150.0],
                        [0.0, 0.0, 300.0, 300.0], [0.0, 0.0, 1000.0, 900.0]],
                       np.float32)
    want = np.asarray(jops.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                                jnp.asarray(boxes), 7))
    got = ops.multilevel_roi_align(
        [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats],
        torch.from_numpy(boxes)[None], 7)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want, atol=ATOL)


def test_multilevel_roi_align_batch_matches_frames():
    rng = np.random.RandomState(4)
    feats = [torch.from_numpy(rng.rand(3, 4, 16 // 2 ** i, 24 // 2 ** i)
                              .astype(np.float32)) for i in range(4)]
    boxes = torch.from_numpy(np.stack([_boxes(rng, 5, 200.0) for _ in range(3)]))
    batch = ops.multilevel_roi_align(feats, boxes, 7)
    for f in range(3):
        one = ops.multilevel_roi_align([x[f:f + 1] for x in feats], boxes[f:f + 1], 7)
        torch.testing.assert_close(batch[f:f + 1], one, rtol=0, atol=0)


def test_box_iou_matches_jax():
    rng = np.random.RandomState(5)
    a, b = _boxes(rng, 7, 50.0), _boxes(rng, 9, 50.0)
    got = ops.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.box_iou(jnp.asarray(a), jnp.asarray(b))),
                               atol=ATOL)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_apply_deltas_and_clip_match_jax(weights):
    rng = np.random.RandomState(6)
    anchors = _boxes(rng, 12, 100.0)
    deltas = rng.normal(0, 2.0, (12, 4)).astype(np.float32)  # some past the clamp
    want = jops.apply_deltas(jnp.asarray(anchors), jnp.asarray(deltas), weights=weights)
    got = ops.apply_deltas(torch.from_numpy(anchors), torch.from_numpy(deltas),
                           weights=weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(ops.clip_boxes(got, (60, 80)).numpy(),
                               np.asarray(jops.clip_boxes(want, (60, 80))),
                               rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("hw,stride,scale", [((2, 3), 8, 32.0), ((5, 4), 64, 512.0)])
def test_generate_anchors_match_jax(hw, stride, scale):
    np.testing.assert_allclose(generate_anchors(hw, stride, scale).numpy(),
                               np.asarray(jax_anchors(hw, stride, scale)), atol=ATOL)


def test_top_k_tie_order_matches_jax():
    """Runs of equal values (the zero padding's constant objectness) come out
    lower index first, exactly as jax.lax.top_k orders them."""
    rng = np.random.RandomState(7)
    x = rng.choice(np.asarray([-1.5, 0.25, 0.25, 2.0, 3.0], np.float32), size=(2, 300))
    x[1, 100:] = 0.25
    for k in (5, 64, 300):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = ops.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
