"""Connected-component label parity of the PyTorch port against the JAX
package (CPU).

The port's plain K6 (``label_components_reference``, what
``label_components`` runs on CPU tensors) against the JAX XLA loop
(``ops/components.label_components``, backend "xla", per mask) and the
Pallas ``label_components_pallas(..., interpret=True)``, exactly: two blobs,
random masks at densities 0.25 and 0.45, a serpentine whose geodesic length
exceeds H + W, empty and full masks, and rounds cut short at 1, 3 and 7,
where a Jacobi propagation must give the same partial labels. Masks are
made with numpy from seeds and handed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.ops import components as jcomp
from video_classification_tpu.ops.pallas_components import label_components_pallas
from video_classification_tpu_torch.ops import components as tcomp
from video_classification_tpu_torch.ops.label_components import (
    INT32_MAX, label_components, label_components_reference)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)


def _serpentine(h, w):
    m = np.zeros((h, w), bool)
    m[0::2] = True
    for i, r in enumerate(range(1, h, 2)):
        m[r, w - 1 if i % 2 == 0 else 0] = True
    return m


def _masks(kind, h, w):
    rng = np.random.RandomState(len(kind) + h)
    if kind == "blobs":
        m = np.zeros((1, h, w), bool)
        m[0, 2:h // 2, 1:w // 3] = True
        m[0, h // 2 + 2:, w // 2:w - 1] = True
        m[0, h - 1, 0] = True  # a single pixel
        return m
    if kind.startswith("random"):
        return rng.rand(4, h, w) < float(kind[6:])
    if kind == "serpentine":
        return _serpentine(h, w)[None]
    if kind == "empty":
        return np.zeros((2, h, w), bool)
    return np.ones((2, h, w), bool)  # full


KINDS = ["blobs", "random0.25", "random0.45", "serpentine", "empty", "full"]
SHAPES = [(14, 12), (9, 23)]


def _jax_xla(masks, max_iters):
    return np.stack([np.asarray(jcomp.label_components(
        jnp.asarray(m), max_iters=max_iters, backend="xla")) for m in masks])


@pytest.mark.parametrize("max_iters", [None, 1, 3, 7])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_labels_match_jax_xla(kind, shape, max_iters):
    masks = _masks(kind, *shape)
    got = label_components(torch.from_numpy(masks), max_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_xla(masks, max_iters))


@pytest.mark.parametrize("max_iters", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_labels_match_pallas_interpret(kind, max_iters):
    masks = _masks(kind, 14, 12)
    want = label_components_pallas(jnp.asarray(masks), max_iters, interpret=True)
    got = label_components(torch.from_numpy(masks), max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serpentine_is_cut_at_h_plus_w():
    """The serpentine needs more than H + W rounds: at the default cap it is
    still unconverged, so the cap is part of the semantics."""
    m = torch.from_numpy(_serpentine(14, 12))[None]
    capped = label_components_reference(m)
    full = label_components_reference(m, max_iters=14 * 12)
    assert not torch.equal(capped, full)
    fg = m != 0
    assert int(full[fg].max()) == 0 and int(capped[fg].max()) > 0


def test_labels_are_component_minima():
    """Converged labels: each foreground pixel carries the smallest
    row-major index of its component; background INT32_MAX."""
    masks = torch.from_numpy(_masks("blobs", 14, 12)).to(torch.uint8)
    lab = tcomp.label_components(masks)[0]
    assert int(lab[0, 0]) == INT32_MAX
    assert int(lab[2, 1]) == 2 * 12 + 1 and int(lab[6, 3]) == 2 * 12 + 1
    assert int(lab[13, 0]) == 13 * 12
    assert set(lab.unique().tolist()) == {25, 9 * 12 + 6, 13 * 12, INT32_MAX}


def test_label_components_checks_its_input():
    with pytest.raises(ValueError):
        label_components(torch.ones((4, 4), dtype=torch.bool))
