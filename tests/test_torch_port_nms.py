"""K3's plain twin against the JAX package's NMS (CPU).

The port's ``nms`` on CPU tensors runs ``nms_reference``, the kernel's
operation order with tensor ops; it must equal the JAX ``nms`` exactly, both
the XLA fixed-trip loop and the Pallas kernel in interpret mode, indices and
mask, including index 0 in empty slots. A CUDA run of the kernel against the
same twin is ``chip_smoke.py`` phase 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.detect import nms as jax_nms
from video_classification_tpu_torch.detect import nms
from video_classification_tpu_torch.detect.nms import NEG, nms_reference
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _boxes(n, seed, extent=60.0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * extent
    sizes = 4 + rng.rand(n, 2) * extent / 3
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


def _check(boxes, scores, max_out, thr):
    got_idx, got_mask = nms(torch.from_numpy(boxes)[None],
                            torch.from_numpy(scores)[None], max_out, thr)
    assert got_idx.dtype == torch.int32 and got_mask.dtype == torch.bool
    assert got_idx.shape == got_mask.shape == (1, max_out)
    for backend in ("xla", "pallas_interpret"):
        want_idx, want_mask = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      max_out, thr, backend=backend)
        np.testing.assert_array_equal(got_mask[0].numpy(), np.asarray(want_mask),
                                      err_msg=backend)
        np.testing.assert_array_equal(got_idx[0].numpy(), np.asarray(want_idx),
                                      err_msg=backend)
    return got_idx[0].numpy(), got_mask[0].numpy()


@pytest.mark.parametrize("n", [20, 64, 1264])
@pytest.mark.parametrize("max_out", [8, 64, "n+3"])
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_random_boxes_match_jax(n, max_out, thr):
    max_out = n + 3 if max_out == "n+3" else max_out
    boxes, scores = _boxes(n, seed=n, extent=60.0 if n < 1000 else 400.0)
    _, mask = _check(boxes, scores, max_out, thr)
    assert mask.any()


def test_equal_scores_match_jax():
    boxes, _ = _boxes(64, seed=1)
    idx, mask = _check(boxes, np.full((64,), 0.5, np.float32), 20, 0.5)
    assert idx[0] == 0 and mask[0]  # the first index wins the tie


def test_duplicate_boxes_match_jax():
    boxes, scores = _boxes(16, seed=2)
    boxes = np.concatenate([boxes, boxes, boxes[:4]])
    scores = np.concatenate([scores, scores[::-1], scores[:4]])
    idx, mask = _check(boxes, scores, 24, 0.5)
    assert mask.sum() <= 16


@pytest.mark.parametrize("sentinel", [NEG, float(np.finfo(np.float32).min)])
def test_all_scores_at_the_sentinel_are_empty(sentinel):
    boxes, _ = _boxes(20, seed=3)
    idx, mask = _check(boxes, np.full((20,), sentinel, np.float32), 8, 0.5)
    assert not mask.any() and not idx.any()


def test_batch_equals_per_frame():
    frames = [_boxes(64, seed=10 + i) for i in range(3)]
    boxes = torch.from_numpy(np.stack([b for b, _ in frames]))
    scores = torch.from_numpy(np.stack([s for _, s in frames]))
    scores[1, :] = float(NEG)  # an empty frame among full ones
    idx, mask = nms(boxes, scores, 12, 0.5)
    for i in range(3):
        one = nms_reference(boxes[i:i + 1], scores[i:i + 1], 12, 0.5)
        assert torch.equal(idx[i], one[0][0]) and torch.equal(mask[i], one[1][0])
        want_idx, want_mask = jax_nms(jnp.asarray(boxes[i].numpy()),
                                      jnp.asarray(scores[i].numpy()), 12, 0.5,
                                      backend="xla")
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(want_mask))
    assert not mask[1].any()


def test_shapes_are_checked():
    with pytest.raises(ValueError):
        nms(torch.zeros((5, 4)), torch.zeros((5,)), 3)
