"""The port's ``DensePoseIUVProvider`` against the JAX package's (CPU, float32).

Three 96x128 padded frames (a 48x64 fixture frame centred in zeros, plus
noise) go through both providers: depth 50, a 14-pixel chart pooler,
budgets 64 / 16 / 4, batches of 2 (so the last chunk is short), and
``min_size`` 120 so that ResizeShortestEdge runs (96x128 -> 120x160: cv2 in
the JAX provider, ``ops/image.resize_linear_u8`` in the port). The JAX
variables are numpy-seeded with small box-delta layers, a stem scaled by
0.01 (pixel-scale input otherwise drives every box to a border) and the
person logit's bias raised by 4 (so some detections clear the 0.05 score
threshold), and carried by ``detect/convert.state_dict_from_jax``. Per
frame: the valid detections' boxes within 1e-3 px and scores within 1e-4
(the detector bars of ``test_torch_port_densepose.py``); where the best
box's integer corners agree, the box-sized labels equal on >= 99.9 % of
pixels (a near-tied chart argmax may flip, as in that file) and U, V within
1e-5 where the labels agree. Then the empty-detection path (a person
logit far below the score threshold), and ``SyntheticIUVProvider`` against
JAX's, identical.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.detect.provider import DensePoseIUVProvider as JaxProvider
from video_classification_tpu.pipeline.iuv_contract import (
    SyntheticIUVProvider as JaxSynthetic)
from video_classification_tpu_torch.detect.provider import DensePoseIUVProvider
from video_classification_tpu_torch.pipeline.iuv_contract import SyntheticIUVProvider
from torch_port_support import detector_variables, one_torch_thread  # noqa: F401

BUDGET = dict(depth=50, pre_nms_topk=64, post_nms_topk=16, max_detections=4,
              chart_pooler_size=14, min_size=120, max_size=200, batch_size=2)
NAMES = [f"/data/ChaLearn/3_Pad/train/001/M_00001/{i * 5:05d}.jpg" for i in range(3)]


def _frames():
    rng = np.random.RandomState(4)
    frames = np.zeros((3, 96, 128, 3), np.uint8)
    body = rng.randint(0, 200, (3, 48, 64, 3)).astype(np.uint8)
    body[:, 10:40, 20:44] = 220
    frames[:, 24:72, 32:96] = body
    return frames


@pytest.fixture(scope="module")
def providers():
    jax_provider = JaxProvider(compute_dtype="float32", **BUDGET)
    shapes = jax.eval_shape(functools.partial(jax_provider.model.init, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((120, 160, 3)))
    variables = detector_variables(shapes, seed=5)
    variables["params"]["backbone"]["stem_conv"]["kernel"] *= 0.01
    variables["params"]["box_head"]["cls"]["bias"][0] += 4.0
    jax_provider.variables = jax.tree.map(jnp.asarray, variables)
    port = DensePoseIUVProvider(variables=variables, device="cpu", **BUDGET)
    return jax_provider, port, variables


def test_auto_dtype_is_float32_on_the_cpu(providers):
    assert providers[1].model.compute_dtype == torch.float32


def test_detections_match_jax(providers):
    jax_provider, port, _ = providers
    frames = _frames()
    want = jax_provider.detect(frames, NAMES)
    got = port.detect(frames, NAMES)
    assert len(got) == len(want) == 3
    compared = 0
    for g, w in zip(got, want):
        assert g.file_name == w.file_name
        assert g.boxes_xyxy.shape == w.boxes_xyxy.shape and w.boxes_xyxy.shape[0] > 0
        assert g.boxes_xyxy.dtype == w.boxes_xyxy.dtype == np.float32
        np.testing.assert_allclose(g.boxes_xyxy, w.boxes_xyxy, atol=1e-3)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-4)
        assert g.labels.dtype == w.labels.dtype == np.uint8
        assert g.uv.dtype == w.uv.dtype == np.float32
        if not np.array_equal(g.best_box(), w.best_box()):
            continue  # the box sizes differ: the charts are not comparable
        compared += 1
        assert g.labels.shape == w.labels.shape and g.uv.shape == w.uv.shape
        same = g.labels == w.labels
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_allclose(g.uv[:, same], w.uv[:, same], atol=1e-5)
    assert compared >= 2


def test_empty_detections_match_jax(providers):
    jax_provider, _, variables = providers
    empty = copy.deepcopy(variables)
    empty["params"]["box_head"]["cls"]["bias"][0] = -100.0  # person logit
    jax_empty = JaxProvider(compute_dtype="float32", **BUDGET)
    jax_empty.variables = jax.tree.map(jnp.asarray, empty)
    port = DensePoseIUVProvider(variables=empty, device="cpu", **BUDGET)
    frames = _frames()[:1]
    (g,), (w,) = port.detect(frames, NAMES[:1]), jax_empty.detect(frames, NAMES[:1])
    for name in ("boxes_xyxy", "scores", "labels", "uv"):
        a, b = getattr(g, name), getattr(w, name)
        assert a.shape == b.shape and a.dtype == b.dtype and a.size == 0, name
    assert g.best_box() is None and g.file_name == NAMES[0]
    assert port.detect(frames[:0], []) == []


def test_refuses_random_weights_unless_asked():
    with pytest.raises(ValueError, match="no weights"):
        DensePoseIUVProvider(depth=50, device="cpu")
    a = DensePoseIUVProvider(depth=50, allow_random_init=True, rng_seed=3, device="cpu")
    b = DensePoseIUVProvider(depth=50, allow_random_init=True, rng_seed=3, device="cpu")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.mark.parametrize("hw", [(96, 128), (480, 640), (61, 47)])
def test_synthetic_provider_matches_jax(hw):
    frames = np.zeros((2,) + hw + (3,), np.uint8)
    got = SyntheticIUVProvider().detect(frames, ["a.jpg"])
    want = JaxSynthetic().detect(frames, ["a.jpg"])
    for g, w in zip(got, want):
        assert g.file_name == w.file_name
        for name in ("boxes_xyxy", "scores", "labels", "uv"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
