"""K3's sorted, chunked greedy scan (``csrc/nms.cu``), emulated on the CPU.

The kernel runs only on the card. This file replays its schedule with numpy
and plain tensor ops, with the kernel's constants read from the source, and
holds the result ``torch.equal`` to ``nms_reference`` (the argmax loop) and
equal to the JAX package's ``detect/ops.nms`` and ``nms_pallas`` in
interpret mode:

- 64-bit keys: the score's order-preserving bits, descending (-0.0 mapped to
  +0.0), then the index, ascending; padded with all-ones keys to a power of
  two of at least 64 and sorted by the kernel's bitonic network (per phase k
  the strides k/2 down to 1, each pair ordered by bit k of its lower
  position);
- chunks of 64 sorted candidates: a candidate is live if its score is above
  NEG/2 and no kept box has IoU above the threshold with it; row t of the
  chunk's bit matrix marks the later candidates that candidate t suppresses;
  one serial walk keeps the lowest live bit and clears its row, until
  max_out boxes are kept; the scan ends after a chunk that holds a score at
  or below NEG/2, or the last box.

Inputs are made with numpy from seeds.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_classification_tpu.detect.ops import nms as jax_nms
from video_classification_tpu.detect.pallas_nms import nms_pallas
from video_classification_tpu_torch.detect.nms import NEG, nms, nms_reference
from video_classification_tpu_torch.utils import cuda
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SOURCE = (cuda.CSRC / "nms.cu").read_text()
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
CHUNK = CONSTS["kChunk"]
HALF_NEG = np.float32(NEG) * np.float32(0.5)
MAX_SMEM = 232448  # dynamic shared memory of one H100 block


def sort_keys(scores):
    """The kernel's keys of a (N,) float32 score vector, as uint64."""
    bits = np.asarray(scores, np.float32).view(np.uint32).copy()
    bits[(bits << np.uint32(1)) == 0] = 0
    neg = (bits & np.uint32(0x80000000)) != 0
    b = np.where(neg, ~bits, bits | np.uint32(0x80000000))
    hi = (~b).astype(np.uint64) << np.uint64(32)
    return hi | np.arange(len(bits), dtype=np.uint64)


def key_score(keys):
    b = ~(np.asarray(keys, np.uint64) >> np.uint64(32)).astype(np.uint32)
    pos = (b & np.uint32(0x80000000)) != 0
    return np.where(pos, b & np.uint32(0x7FFFFFFF), ~b).astype(np.uint32).view(np.float32)


def padded(n):
    p = 64
    while p < n:
        p *= 2
    return p


def bitonic(keys):
    """The kernel's network on keys padded to a power of two."""
    n = len(keys)
    a = keys.copy()
    pos = np.arange(n)
    k = 2
    while k <= n:
        j = k // 2
        while j > 0:
            lo = pos[(pos & j) == 0]
            hi = lo + j
            asc = (lo & k) == 0
            x, y = a[lo], a[hi]
            swap = (x > y) == asc
            a[lo], a[hi] = np.where(swap, y, x), np.where(swap, x, y)
            j //= 2
        k *= 2
    return a


def suppresses(j, k, thr):
    """IoU(j, k) > thr for (..., 4) float32 tensors, j as the twin's
    candidate and k as its best box, in the twin's operations."""
    def area(b):
        return torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)

    iw = torch.clamp(torch.minimum(j[..., 2], k[..., 2]) - torch.maximum(j[..., 0], k[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(j[..., 3], k[..., 3]) - torch.maximum(j[..., 1], k[..., 1]), min=0.0)
    inter = iw * ih
    return inter / torch.clamp(area(j) + area(k) - inter, min=1e-9) > thr


def chunked_scan(boxes, scores, max_out, thr):
    """One frame's (idx, mask) by the kernel's schedule, and a trace of
    (candidates live after the kept boxes, kept) per chunk."""
    n = len(scores)
    keys = np.full(padded(n), np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = sort_keys(scores)
    keys = bitonic(keys)
    b = torch.from_numpy(np.asarray(boxes, np.float32))
    thr = torch.tensor(thr, dtype=torch.float32)
    kept, trace = [], []
    base = 0
    while base < n and len(kept) < max_out:
        pos = np.arange(base, min(base + CHUNK, n))
        idx = (keys[pos] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        cb = b[idx]
        live = torch.from_numpy(key_score(keys[pos]) > HALF_NEG)
        if kept:
            live &= ~suppresses(cb[:, None], b[kept][None], thr).any(1)
        # rows[t, o]: candidate t, once kept, suppresses the later o.
        rows = suppresses(cb[None, :], cb[:, None], thr)
        rows &= torch.arange(len(pos))[None, :] > torch.arange(len(pos))[:, None]
        alive = live.clone()
        n_kept = len(kept)
        while bool(alive.any()) and len(kept) < max_out:
            t = int(torch.nonzero(alive)[0])
            kept.append(int(idx[t]))
            alive &= ~rows[t]
            alive[t] = False
        trace.append((int(live.sum()), len(kept) - n_kept))
        if not key_score(keys[pos[-1:]])[0] > HALF_NEG:
            break
        base += CHUNK
    out_idx = np.zeros(max_out, np.int32)
    out_idx[:len(kept)] = kept
    mask = np.arange(max_out) < len(kept)
    return torch.from_numpy(out_idx), torch.from_numpy(mask), trace


def _boxes(n, seed, extent=60.0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, 2) * extent
    sizes = 4 + rng.rand(n, 2) * extent / 3
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    return boxes.astype(np.float32), rng.rand(n).astype(np.float32)


def _check(boxes, scores, max_out, thr, jax_too=False):
    idx, mask, trace = chunked_scan(boxes, scores, max_out, thr)
    want_idx, want_mask = nms_reference(torch.from_numpy(boxes)[None],
                                        torch.from_numpy(scores)[None], max_out, thr)
    assert torch.equal(idx, want_idx[0]) and torch.equal(mask, want_mask[0])
    if jax_too:
        for got in (jax_nms(jnp.asarray(boxes), jnp.asarray(scores), max_out, thr,
                            backend="xla"),
                    nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), max_out, thr,
                               interpret=True)):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(got[0]))
            np.testing.assert_array_equal(mask.numpy(), np.asarray(got[1]))
    return idx, mask, trace


def test_constants_match_the_source():
    """64 candidates per chunk, eight threads each, and the serving N and
    the provider budget N = 5000 fit one block's shared memory
    (``nms_smem_bytes``: 20 B per box, 8 B per padded key)."""
    assert CHUNK == 64 and CONSTS["kThreads"] == CHUNK * 8
    assert "kPerCandidate = kThreads / kChunk" in SOURCE
    assert "20 * N + 8 * (int64_t)padded(N)" in SOURCE
    for n in (64, 1264, 5000, 8192):
        assert 20 * n + 8 * padded(n) <= MAX_SMEM
    assert 20 * 8193 + 8 * padded(8193) > MAX_SMEM


def test_key_order():
    """Keys sort by score descending, ties (and -0.0 against +0.0) by index
    ascending; -inf and NEG sort after every finite score above them."""
    scores = np.array([0.5, -0.0, 0.5, 0.0, -np.inf, NEG, 1.0, -1.0, 0.0, -0.0,
                       np.float32(1e-45), -2e38], np.float32)
    got = [int(k & np.uint64(0xFFFFFFFF)) for k in np.sort(sort_keys(scores))]
    want = sorted(range(len(scores)), key=lambda i: (-(scores[i] + 0.0), i))
    assert got == want
    assert got[:4] == [6, 0, 2, 10] and got[4:8] == [1, 3, 8, 9]
    assert got[-3:] == [11, 5, 4]
    np.testing.assert_array_equal(key_score(sort_keys(scores)), scores + np.float32(0.0))


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 127, 129, 1264, 5000])
def test_bitonic_network_sorts(n):
    rng = np.random.RandomState(n)
    scores = rng.rand(n).astype(np.float32)
    scores[rng.rand(n) < 0.3] = 0.25  # ties
    keys = np.full(padded(n), np.iinfo(np.uint64).max, np.uint64)
    keys[:n] = sort_keys(scores)
    np.testing.assert_array_equal(bitonic(keys), np.sort(keys))


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1264])
@pytest.mark.parametrize("max_out,thr", [(8, 0.5), (64, 0.7), ("n+3", 0.5)])
def test_scan_equals_the_argmax_loop(n, max_out, thr):
    max_out = n + 3 if max_out == "n+3" else max_out
    boxes, scores = _boxes(n, seed=n, extent=60.0 if n < 1000 else 400.0)
    _check(boxes, scores, max_out, thr, jax_too=n < 1000 or max_out == 64)


def test_max_out_reached_in_the_middle_of_a_chunk():
    boxes, scores = _boxes(200, seed=5, extent=600.0)
    idx, mask, trace = _check(boxes, scores, 37, 0.5, jax_too=True)
    assert mask.all() and len(trace) == 1 and trace[0][0] > 37


def test_a_chunk_the_kept_boxes_suppress_entirely():
    """Chunk 1: 64 disjoint boxes; chunk 2: a shifted copy of each, every
    one overlapping its original; chunk 3: disjoint new boxes."""
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(64, 2) * 20.0
    first = np.concatenate([grid, grid + 10.0], 1).astype(np.float32)
    copies = first + np.float32(0.5)
    third = first + np.float32(400.0)
    boxes = np.concatenate([first, copies, third])
    scores = np.concatenate([np.linspace(0.99, 0.8, 64), np.linspace(0.79, 0.6, 64),
                             np.linspace(0.59, 0.4, 64)]).astype(np.float32)
    idx, mask, trace = _check(boxes, scores, 150, 0.5, jax_too=True)
    assert [t[0] for t in trace] == [64, 0, 64]
    assert int(mask.sum()) == 128


def test_duplicates_and_ties():
    b16, s16 = _boxes(16, seed=2)
    boxes = np.concatenate([b16] * 5)
    scores = np.concatenate([s16, s16[::-1], s16, np.full(16, 0.5, np.float32), -s16])
    scores[3] = -0.0
    scores[20] = 0.0
    scores[40] = -np.inf
    scores[41] = NEG
    _check(boxes, scores.astype(np.float32), 80, 0.5, jax_too=True)
    _check(boxes, scores.astype(np.float32), 80, 0.0)


def test_scan_stops_at_the_first_invalid_score():
    boxes, scores = _boxes(150, seed=7, extent=2000.0)
    scores[70:] = NEG
    idx, mask, trace = _check(boxes, scores, 140, 0.5, jax_too=True)
    assert len(trace) == 2 and 0 < int(mask.sum()) <= 70 and trace[1][0] <= 6
    boxes, _ = _boxes(20, seed=3)
    idx, mask, trace = _check(boxes, np.full((20,), NEG, np.float32), 8, 0.5)
    assert not mask.any() and not idx.any() and trace == [(0, 0)]


def test_batches_past_the_shared_memory_raise_before_launching():
    """The wrapper's shape check runs first on any device. N whose boxes
    and keys exceed a block (N > 8192) no longer raise: the binding takes
    the device-memory route there (test_torch_port_nms_large.py)."""
    with pytest.raises(ValueError):
        nms(torch.zeros((1, 5, 3)), torch.zeros((1, 5)), 3)
    bindings = (cuda.CSRC / "bindings.cpp").read_text()
    assert "nms_smem_bytes(N) <= kMaxSmem" in bindings
    assert "nms_scratch_bytes(B, N, max_out, kMaxSmem)" in bindings
