"""K2's propagation (``csrc/component_extents.cu`` on
``csrc/cluster_strips.cuh``), emulated on the CPU.

The kernel runs only on the card. This file replays its schedule with plain
tensor ops (``cluster_strips_emulation``: strips of rows over a cluster of
CTAs, S iterations per halo exchange, poisoned cells that must be
rewritten), with the constants read from the sources, and holds the result
``torch.equal`` to ``component_extents_reference``, for both word layouts:

- narrow, H, W <= 255: each pixel is one word of four bytes, min_row,
  254 - max_row, min_col, 254 - max_col, all four fields minima, background
  0xFF in every byte;
- wide, larger masks: two passes of one word of two 16-bit fields, (min_row,
  65534 - max_row) and (min_col, 65534 - max_col), background 0xFFFF in each
  field, each pass stopping on its own; on the cluster when its strips fit
  shared memory, else by the device-memory route;
decoded to int32 with the exact sentinels.

Shapes from a single row or column up to 255x255 (narrow) and from 1x256
and 256x1 to 480x640 (wide); masks made with numpy from seeds.
"""

import math
import re

import numpy as np
import pytest
import torch

from video_classification_tpu_torch.ops.component_extents import (
    CLUSTER, ITERS_PER_SYNC, MAX_SIDE, NARROW_SIDE, component_extents_reference)
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from video_classification_tpu_torch.config.crop_cfg import crop_part_args
from video_classification_tpu_torch.ops.components import part_mask
from video_classification_tpu_torch.utils import cuda
from cluster_strips_emulation import HEADER, cluster_run, device_run, fits_cluster
import cluster_strips_emulation as emulation
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SOURCE = (cuda.CSRC / "component_extents.cu").read_text()
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
WIDE_CHUNKS = int(re.search(r"struct Wide \{.*?kMaxChunks = (\d+);", SOURCE, re.S)[1])
BG = 0xFF
WIDE_BG = 0xFFFF
M = 65534  # the wide fields' complement: a maximum m is stored as M - m
INT32_MAX = 2 ** 31 - 1


def launchable(h, w):
    """The narrow words' launch check (``fits_cluster`` of the header), which
    every mask up to 255x255 passes."""
    return fits_cluster(h, w, -(-NARROW_SIDE // 32))


def route(h, w):
    """``component_extents_route``: narrow words on the cluster, wide words
    on the cluster, or wide words in device memory."""
    if h <= NARROW_SIDE and w <= NARROW_SIDE:
        return "narrow"
    return "wide" if fits_cluster(h, w, WIDE_CHUNKS) else "device"


def encode(fg):
    """(H, W) bool -> (H, W, 4) int64 bytes (min_row, 254 - max_row,
    min_col, 254 - max_col), background BG."""
    h, w = fg.shape
    y = torch.arange(h).view(h, 1).expand(h, w)
    x = torch.arange(w).view(1, w).expand(h, w)
    lanes = torch.stack([y, 254 - y, x, 254 - x], -1)
    return torch.where(fg[..., None], lanes, torch.full_like(lanes, BG))


def decode(lanes):
    """(..., 4) bytes -> (min_row, max_row, min_col, max_col) int32."""
    def field(lane, bg, complement):
        v = 254 - lane if complement else lane
        return torch.where(lane == BG, torch.full_like(lane, bg), v).to(torch.int32)

    return (field(lanes[..., 0], INT32_MAX, False), field(lanes[..., 1], -1, True),
            field(lanes[..., 2], INT32_MAX, False), field(lanes[..., 3], -1, True))


def cluster_extents(mask, max_iters):
    """One (H, W) mask of at most 255x255 by the kernel's schedule of narrow
    words; the four int32 fields and the iterations run."""
    words, done = cluster_run(encode(mask), BG, max_iters)
    return decode(words), done


def encode_wide(fg, rows):
    """(H, W) bool -> (H, W, 2) int64 16-bit fields of one pass, (v, M - v)
    with v the row (pass 0) or column (pass 1), background WIDE_BG."""
    h, w = fg.shape
    v = (torch.arange(h).view(h, 1) if rows else torch.arange(w).view(1, w)).expand(h, w)
    fields = torch.stack([v, M - v], -1)
    return torch.where(fg[..., None], fields, torch.full_like(fields, WIDE_BG))


def decode_wide(fields):
    """(..., 2) 16-bit fields of one pass -> (min, max) int32."""
    lo, hi = fields[..., 0], fields[..., 1]
    return (torch.where(lo == WIDE_BG, torch.full_like(lo, INT32_MAX), lo).to(torch.int32),
            torch.where(hi == WIDE_BG, torch.full_like(hi, -1), M - hi).to(torch.int32))


def wide_extents(mask, max_iters):
    """One (H, W) mask by the wide words' route: pass 0 rows, pass 1
    columns, each stopping on its own; the four int32 fields and each
    pass's iterations."""
    run = cluster_run if route(*mask.shape) == "wide" else device_run
    fields, ran = [], []
    for rows in (True, False):
        words, done = run(encode_wide(mask, rows), WIDE_BG, max_iters)
        fields += decode_wide(words)
        ran.append(done)
    return tuple(fields), ran


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
    side = max(h, w)
    charts = torch.from_numpy(SyntheticOnlineDetector(side)._charts())
    return part_mask(charts, crop_part_args[0][0]).numpy()[:h, :w]


def _check(m, max_iters=None, emulate=cluster_extents):
    h, w = m.shape
    max_iters = h + w if max_iters is None else max_iters
    mask = torch.from_numpy(np.ascontiguousarray(m))
    want = component_extents_reference(mask[None], max_iters)
    got, _ = emulate(mask, max_iters)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt[0])


SHAPES = [(1, 37), (29, 1), (13, 17), (57, 76), (112, 112), (255, 255)]
KINDS = ["random", "sparse", "empty", "charts", "serpentine", "serpentine_vertical"]


def test_constants_match_the_source():
    assert CONSTS["kNarrowSide"] == NARROW_SIDE == 255
    assert CONSTS["kMaxSide"] == MAX_SIDE == M
    assert "kMaxChunks = (kNarrowSide + 31) / 32;" in SOURCE
    assert emulation.CLUSTER == CLUSTER and 1 < CLUSTER <= 8  # a portable cluster size
    assert emulation.ITERS_PER_SYNC == ITERS_PER_SYNC >= 1
    assert "s.rows = (H + kCluster - 1) / kCluster;" in HEADER
    assert "s.S = std::min(kItersPerSync, s.rows);" in HEADER
    assert "s.smem = (size_t)(2 * (s.rows + 2 * s.S) + 4 * s.S) * s.chunks * 32 * 4;" in HEADER
    assert "constexpr int kStaticSmem = 2 * 8 + 2 * kCluster * 4;" in HEADER
    # The cluster takes every mask up to 255x255 in narrow words.
    assert launchable(NARROW_SIDE, NARROW_SIDE)


def test_packed_words_decode_and_take_minima():
    """The kernel's word: byte 0 min_row, byte 1 254 - max_row, byte 2
    min_col, byte 3 254 - max_col; a byte-wise minimum (__vminu4) of two
    words is the field-wise min / max of what they encode, and background
    (0xFFFFFFFF) loses."""
    rng = np.random.RandomState(0)
    lanes = rng.randint(0, 255, size=(500, 2, 4)).astype(np.uint8)
    lanes[rng.rand(500, 2) < 0.2] = BG
    words = lanes.view(np.uint32)[..., 0]  # little-endian: byte 0 lowest
    assert (words[:, 0] & 0xFF == lanes[:, 0, 0]).all()
    vmin = np.minimum(words[:, 0:1].view(np.uint8), words[:, 1:2].view(np.uint8))
    got = decode(torch.from_numpy(vmin.astype(np.int64)))
    pair = [decode(torch.from_numpy(lanes[:, i].astype(np.int64))) for i in (0, 1)]
    want = (torch.minimum(pair[0][0], pair[1][0]), torch.maximum(pair[0][1], pair[1][1]),
            torch.minimum(pair[0][2], pair[1][2]), torch.maximum(pair[0][3], pair[1][3]))
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)
    fg = torch.ones((255, 255), dtype=torch.bool)
    mnr, mxr, mnc, mxc = decode(encode(fg))
    assert int(mnr[254, 3]) == int(mxr[254, 3]) == 254 and int(mxc[7, 254]) == 254
    assert [int(f[0, 0]) for f in decode(encode(~fg))] == [INT32_MAX, -1, INT32_MAX, -1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_cluster_schedule_equals_the_plain_propagation(hw, kind):
    h, w = hw
    _check(_mask(kind, h, w))


@pytest.mark.parametrize("max_iters", [0, 1, 2, "S-1", "S", "S+1", "H+W-1", "H+W"])
@pytest.mark.parametrize("kind", ["random", "serpentine", "serpentine_vertical"])
@pytest.mark.parametrize("hw", [(1, 37), (29, 1), (13, 17), (57, 76), (112, 112)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_iteration_cap(hw, kind, max_iters):
    """S iterations per halo exchange, the last batch clipped: every cap
    stops the emulated kernel where the plain loop stops (a single row is
    one strip of 1 and three empty ones, so S is cut to 1 there)."""
    h, w = hw
    S = ITERS_PER_SYNC
    cap = {"S-1": S - 1, "S": S, "S+1": S + 1, "H+W-1": h + w - 1,
           "H+W": h + w}.get(max_iters, max_iters)
    _check(_mask(kind, h, w), cap)


def test_serpentines_cross_every_strip_and_stop_at_the_cap():
    """At 57x76 both serpentines are longer than H + W, so the cap ends the
    run, and each reaches every CTA's strip."""
    for m in (_serpentine(57, 76), _serpentine(76, 57).T):
        mask = torch.from_numpy(np.ascontiguousarray(m))
        _, ran = cluster_extents(mask, 57 + 76)
        assert ran == 57 + 76
        rows = -(-57 // CLUSTER)
        assert all(m[r * rows:(r + 1) * rows].any() for r in range(math.ceil(57 / rows)))


def test_wide_words_decode_and_take_minima():
    """The wide word: bits 0-15 the minimum, bits 16-31 M - the maximum
    (M = 65534); a halfword-wise minimum (__vminu2) of two words is the
    field-wise min / max of what they encode, and background (0xFFFF in
    each field) loses; the field reaches 65534 at both ends."""
    rng = np.random.RandomState(1)
    fields = rng.randint(0, M + 1, size=(500, 2, 2)).astype(np.uint16)
    fields[rng.rand(500, 2) < 0.2] = WIDE_BG
    words = fields.view(np.uint32)[..., 0]  # little-endian: the minimum lowest
    assert (words[:, 0] & 0xFFFF == fields[:, 0, 0]).all()
    vmin = np.minimum(words[:, 0:1].view(np.uint16), words[:, 1:2].view(np.uint16))
    got = decode_wide(torch.from_numpy(vmin.astype(np.int64)))
    pair = [decode_wide(torch.from_numpy(fields[:, i].astype(np.int64))) for i in (0, 1)]
    assert torch.equal(got[0], torch.minimum(pair[0][0], pair[1][0]))
    assert torch.equal(got[1], torch.maximum(pair[0][1], pair[1][1]))
    top = torch.tensor([[M, 0], [0, M], [WIDE_BG, WIDE_BG]])
    assert [f.tolist() for f in decode_wide(top)] == [[M, 0, INT32_MAX], [M, 0, -1]]
    fg = torch.ones((3, M + 1), dtype=torch.bool)
    mn, mx = decode_wide(encode_wide(fg, rows=False))
    assert int(mn[1, M]) == int(mx[1, M]) == M and int(mx[2, 0]) == 0
    assert [int(f[0, 0]) for f in decode_wide(encode_wide(~fg, rows=True))] == [INT32_MAX, -1]


def test_routes():
    """Narrow words up to 255x255; wide words on the cluster where their
    strips fit (up to 320 columns: a 240x320 mask does, 300x320 does not),
    else in device memory (480x640)."""
    assert [route(*hw) for hw in [(255, 255), (1, 255), (255, 1)]] == ["narrow"] * 3
    assert [route(*hw) for hw in [(1, 256), (256, 1), (257, 300), (240, 320),
                                  (296, 320), (388, 256)]] == ["wide"] * 6
    assert [route(*hw) for hw in [(300, 320), (480, 640), (4, 321), (389, 256),
                                  (MAX_SIDE, MAX_SIDE)]] == ["device"] * 5
    rows, S, stride = emulation.strip_shape(240, 320)
    assert (rows, S, stride) == (60, 4, 320)
    assert (2 * (rows + 2 * S) + 4 * S) * stride * 4 == 194560


WIDE_SHAPES = [(1, 256), (256, 1), (257, 300), (240, 320)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", WIDE_SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_wide_schedule_equals_the_plain_propagation(hw, kind):
    h, w = hw
    assert route(h, w) == "wide"
    _check(_mask(kind, h, w), emulate=wide_extents)


@pytest.mark.parametrize("max_iters", [0, 1, 2, "S-1", "S", "S+1", "H+W-1", "H+W"])
@pytest.mark.parametrize("hw,kind", [((1, 256), "serpentine"), ((256, 1), "serpentine_vertical"),
                                     ((257, 300), "sparse"), ((240, 320), "charts")],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_wide_iteration_cap(hw, kind, max_iters):
    h, w = hw
    S = ITERS_PER_SYNC
    cap = {"S-1": S - 1, "S": S, "S+1": S + 1, "H+W-1": h + w - 1,
           "H+W": h + w}.get(max_iters, max_iters)
    _check(_mask(kind, h, w), cap, emulate=wide_extents)


@pytest.mark.parametrize("max_iters", [0, 1, ITERS_PER_SYNC, None])
def test_wide_device_route_sparse_480x640(max_iters):
    """A sparse 480x640 mask (the 2x-padded frame) fits no cluster: the
    device-memory route, each pass stopping on its own."""
    assert route(480, 640) == "device"
    _check(_mask("sparse", 480, 640), max_iters, emulate=wide_extents)
