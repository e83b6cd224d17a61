"""Component-extent parity of the PyTorch port against the JAX package (CPU).

The port's plain K2 (``component_extents_reference``, what
``component_extents`` runs on CPU tensors) against the Pallas
``component_extents_pallas(..., interpret=True)``, and the port's
``largest_component_bbox`` against the JAX function, exactly, on random
masks, the synthetic detector's part masks and a serpentine whose geodesic
diameter exceeds H + W (so both stop at the same iteration cap). Past 255 px
a side (the wide words of kernel K2 on the card), on part masks of the
synthetic detector's 112x112 charts nearest-resized to a person box, as the
JAX offline chain's provider re-rasterises them (``detect/provider.py``),
the port's ``component_extents_reference`` against JAX
``_component_extents_xla`` and its ``largest_component_bbox`` against
JAX's, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.config.crop_cfg import crop_part_args as jax_parts
from video_classification_tpu.ops import components as jcomp
from video_classification_tpu.ops.pallas_components import component_extents_pallas
from video_classification_tpu.pipeline.online import (
    SyntheticOnlineDetector as JaxDetector)
from video_classification_tpu_torch.config.crop_cfg import crop_part_args
from video_classification_tpu_torch.ops import components as tcomp
from video_classification_tpu_torch.ops.component_extents import (
    component_extents, component_extents_reference)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _serpentine(h, w):
    m = np.zeros((h, w), bool)
    m[0::2] = True
    for i, r in enumerate(range(1, h, 2)):
        m[r, w - 1 if i % 2 == 0 else 0] = True
    return m


def _masks(kind, h, w, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.rand(6, h, w) < 0.45
    if kind == "sparse":
        return rng.rand(6, h, w) < 0.2
    if kind == "empty":
        return np.zeros((2, h, w), bool)
    if kind == "serpentine":
        return _serpentine(h, w)[None]
    charts = JaxDetector(h)._charts()
    return np.stack([np.isin(charts, ids) for ids, _ in jax_parts])


CASES = [("random", 13, 17), ("sparse", 24, 24), ("empty", 8, 8),
         ("serpentine", 14, 12), ("charts", 56, 56)]


@pytest.mark.parametrize("kind,h,w", CASES)
def test_extents_match_pallas_interpret(kind, h, w):
    masks = _masks(kind, h, w)
    want = component_extents_pallas(jnp.asarray(masks), None, interpret=True)
    got = component_extents(torch.from_numpy(masks))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


@pytest.mark.parametrize("kind,h,w", CASES)
def test_largest_component_bbox_matches_jax(kind, h, w):
    masks = _masks(kind, h, w, seed=1)
    bbox, valid = tcomp.largest_component_bbox(torch.from_numpy(masks))
    for i, m in enumerate(masks):
        jb, jv = jcomp.largest_component_bbox(jnp.asarray(m), backend="xla")
        np.testing.assert_array_equal(bbox[i].numpy(), np.asarray(jb))
        assert bool(valid[i]) == bool(jv)


def test_serpentine_stops_at_the_iteration_cap():
    """The serpentine needs more than H + W Jacobi iterations: capped at
    H + W it is still unconverged, so the cap is part of the semantics."""
    m = torch.from_numpy(_serpentine(14, 12))[None]
    capped = component_extents_reference(m)
    full = component_extents_reference(m, max_iters=14 * 12)
    assert not all(torch.equal(a, b) for a, b in zip(capped, full))


def test_part_mask_and_taxonomy_match_jax():
    assert crop_part_args == jax_parts
    charts = JaxDetector(56)._charts()
    for ids, _ in crop_part_args:
        want = np.asarray(jcomp.part_mask(jnp.asarray(charts), ids))
        got = tcomp.part_mask(torch.from_numpy(charts), ids).numpy()
        np.testing.assert_array_equal(got, want)


def _box_part_masks(h, w, parts):
    """The synthetic detector's 112x112 charts nearest-resized to an h x w
    box (cv2.INTER_NEAREST's source index floor(i * 112 / h)), then the part
    masks of the crop streams ``parts``."""
    charts = JaxDetector(112)._charts()
    ys = np.minimum(np.arange(h) * charts.shape[0] // h, charts.shape[0] - 1)
    xs = np.minimum(np.arange(w) * charts.shape[1] // w, charts.shape[1] - 1)
    boxed = charts[ys][:, xs]
    return np.stack([np.isin(boxed, jax_parts[p][0]) for p in parts])


# Person boxes on the 2x-padded 480x640 frame: taller than 255, wider than
# 255, and the whole frame, with the CropHTAH, CropLHand and CropTorso part
# masks (the hand's alone on the whole frame, to keep the plain loop short).
BOXES = [((257, 300), (0, 1, 5)), ((240, 320), (0, 1, 5)), ((480, 640), (1,))]
BOX_IDS = [f"{h}x{w}" for (h, w), _ in BOXES]


@pytest.mark.parametrize("hw,parts", BOXES, ids=BOX_IDS)
def test_extents_above_255_match_jax_xla(hw, parts):
    masks = _box_part_masks(*hw, parts)
    got = component_extents(torch.from_numpy(masks))
    for i, m in enumerate(masks):
        want = jcomp._component_extents_xla(jnp.asarray(m))
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(wnt))


@pytest.mark.parametrize("hw,parts", BOXES, ids=BOX_IDS)
def test_largest_component_bbox_above_255_matches_jax(hw, parts):
    masks = _box_part_masks(*hw, parts)
    bbox, valid = tcomp.largest_component_bbox(torch.from_numpy(masks))
    assert bool(valid.all())
    for i, m in enumerate(masks):
        jb, jv = jcomp.largest_component_bbox(jnp.asarray(m), backend="xla")
        np.testing.assert_array_equal(bbox[i].numpy(), np.asarray(jb))
        assert bool(valid[i]) == bool(jv)
