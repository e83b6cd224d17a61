"""K6's propagation (``csrc/label_components.cu`` on
``csrc/cluster_strips.cuh``), emulated on the CPU.

The kernel runs only on the card. This file replays its schedule with plain
tensor ops (``cluster_strips_emulation``: strips of rows over a cluster of
CTAs, S iterations per halo exchange, poisoned cells that must be
rewritten; the device-memory route for masks whose strips do not fit), with
the constants read from the sources, and holds the labels ``torch.equal`` to
``label_components_reference``, and on the small shapes also to the JAX
package's ``ops/components.label_components(backend="xla")``:

- a label is one 32-bit word, r * W + c on the foreground, INT32_MAX on the
  background, and the minimum is the plain one;
- the rounds are Jacobi, so a cap that cuts them short gives the plain
  loop's partial labels.

Shapes from a single row or column up to 240x320 (the largest frame, on the
cluster) and past it (device memory); masks made with numpy from seeds.
"""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.ops import components as jcomp
from video_classification_tpu_torch.config.crop_cfg import crop_part_args
from video_classification_tpu_torch.ops.components import part_mask
from video_classification_tpu_torch.ops.label_components import (
    INT32_MAX, label_components_reference)
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from video_classification_tpu_torch.utils import cuda
from cluster_strips_emulation import (
    CLUSTER, HEADER, ITERS_PER_SYNC, cluster_run, device_run, fits_cluster, strip_shape)
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SOURCE = (cuda.CSRC / "label_components.cu").read_text()
MAX_CHUNKS = int(re.search(r"struct Labels \{.*?kMaxChunks = (\d+);", SOURCE, re.S)[1])
S = ITERS_PER_SYNC


def route(h, w):
    """``label_components_route``: the cluster when the strips fit."""
    return "cluster" if fits_cluster(h, w, MAX_CHUNKS) else "device"


def cluster_labels(mask, max_iters):
    """One (H, W) mask by the kernel's route; the labels and the rounds
    run."""
    h, w = mask.shape
    lin = torch.arange(h * w, dtype=torch.int32).view(h, w)
    words = torch.where(mask, lin, torch.full_like(lin, INT32_MAX))[..., None]
    run = cluster_run if route(h, w) == "cluster" else device_run
    labels, done = run(words, INT32_MAX, max_iters)
    return labels[..., 0], done


def _serpentine(h, w):
    m = np.zeros((h, w), bool)
    m[0::2] = True
    for i, r in enumerate(range(1, h, 2)):
        m[r, w - 1 if i % 2 == 0 else 0] = True
    return m


def _mask(kind, h, w, seed=0):
    rng = np.random.RandomState(seed + h * 1000 + w)
    if kind == "random":
        return rng.rand(h, w) < 0.45
    if kind == "sparse":
        return rng.rand(h, w) < 0.15
    if kind == "empty":
        return np.zeros((h, w), bool)
    if kind == "serpentine":  # across every column, down every strip
        return _serpentine(h, w)
    if kind == "serpentine_vertical":
        return _serpentine(w, h).T
    charts = torch.from_numpy(SyntheticOnlineDetector(max(h, w))._charts())
    return part_mask(charts, crop_part_args[0][0]).numpy()[:h, :w]


def _check(m, max_iters=None):
    h, w = m.shape
    max_iters = h + w if max_iters is None else max_iters
    mask = torch.from_numpy(np.ascontiguousarray(m))
    want = label_components_reference(mask[None], max_iters)[0]
    got, _ = cluster_labels(mask, max_iters)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if h * w <= 1000:
        jax_labels = jcomp.label_components(jnp.asarray(m), max_iters=max_iters, backend="xla")
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_labels))


SHAPES = [(1, 37), (29, 1), (1, 320), (240, 1), (13, 17), (57, 76), (112, 112), (240, 320)]
KINDS = ["random", "sparse", "empty", "charts", "serpentine", "serpentine_vertical"]
CAPS = [0, 1, 2, "S-1", "S", "S+1", "H+W-1", "H+W"]


def _cap(name, h, w):
    return {"S-1": S - 1, "S": S, "S+1": S + 1, "H+W-1": h + w - 1,
            "H+W": h + w}.get(name, name)


def test_constants_match_the_source():
    """K6 runs the header's schedule on int32 labels: background INT32_MAX,
    r * W + c on the foreground, the plain minimum; a 240x320 mask's strips
    fit a cluster (60 rows and 4 halo rows of 320 words per CTA)."""
    assert "static constexpr uint32_t kBg = INT_MAX;" in SOURCE
    assert "return (uint32_t)(y * W + x);" in SOURCE
    assert "return ::min(a, b);" in SOURCE
    assert "cs::propagate<Labels, NCH>(a);" in SOURCE
    assert "cs::device_step<Labels>(a, k);" in SOURCE
    assert "s.rows = (H + kCluster - 1) / kCluster;" in HEADER
    assert CLUSTER == 4 and S == 4 and MAX_CHUNKS == 10
    assert strip_shape(240, 320) == (60, 4, 320)
    assert 2 * 68 * 320 * 4 + 4 * 4 * 320 * 4 == 194560
    assert route(240, 320) == "cluster"
    assert [route(*hw) for hw in [(300, 320), (4, 321), (480, 640)]] == ["device"] * 3


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_cluster_schedule_equals_the_plain_propagation(hw, kind):
    h, w = hw
    assert route(h, w) == "cluster"
    _check(_mask(kind, h, w))


@pytest.mark.parametrize("max_iters", CAPS)
@pytest.mark.parametrize("kind", ["random", "serpentine", "serpentine_vertical"])
@pytest.mark.parametrize("hw", [(1, 37), (29, 1), (13, 17), (57, 76), (112, 112)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_iteration_cap(hw, kind, max_iters):
    """S rounds per halo exchange, the last batch clipped: every cap stops
    the emulated kernel where the plain loop stops, with its partial
    labels (a single row is one strip of 1 and three empty ones, so S is
    cut to 1 there)."""
    h, w = hw
    _check(_mask(kind, h, w), _cap(max_iters, h, w))


@pytest.mark.parametrize("max_iters", CAPS)
def test_iteration_cap_240x320(max_iters):
    """The same caps on the largest cluster shape, a serpentine down every
    strip."""
    _check(_mask("serpentine_vertical", 240, 320), _cap(max_iters, 240, 320))


@pytest.mark.parametrize("max_iters", [0, 1, S, None])
@pytest.mark.parametrize("hw,kind", [((300, 320), "random"), ((6, 400), "serpentine")],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_device_route(hw, kind, max_iters):
    """Masks whose strips fit no cluster (too many rows, or rows wider than
    the cluster route's chunks) run one launch per round in device memory."""
    h, w = hw
    assert route(h, w) == "device"
    _check(_mask(kind, h, w), max_iters)


def test_serpentines_cross_every_strip_and_stop_at_the_cap():
    """At 57x76 both serpentines are longer than H + W, so the cap ends the
    run, and each reaches every CTA's strip."""
    for m in (_serpentine(57, 76), _serpentine(76, 57).T):
        mask = torch.from_numpy(np.ascontiguousarray(m))
        _, ran = cluster_labels(mask, 57 + 76)
        assert ran == 57 + 76
        rows = -(-57 // CLUSTER)
        assert all(m[r * rows:(r + 1) * rows].any() for r in range(math.ceil(57 / rows)))
