"""K2's cluster schedule (``csrc/component_extents.cu``), emulated on the CPU.

The kernel runs only on the card. This file replays its schedule with plain
tensor ops, with the kernel's constants read from the source, and holds the
result ``torch.equal`` to ``component_extents_reference``:

- each pixel is one word of four bytes, min_row, 254 - max_row, min_col,
  254 - max_col, all four fields minima, background 0xFF in every byte;
  decoded to int32 with the exact sentinels;
- a cluster of C = CLUSTER CTAs per mask; CTA r owns rows
  [r * rows, (r + 1) * rows), rows = ceil(H / C), in two Jacobi buffers of
  (rows + 2 S) x W words, the strip with S = min(ITERS_PER_SYNC, rows) halo
  rows above and below;
- S iterations per halo exchange: a batch copies the CTA's inbox into its
  halo rows, then iteration s = 1..S takes the separable 3x3 minimum
  (vertical from the buffer, horizontal from the neighbouring columns,
  background past the row's ends) on the foreground of the strip and
  S - s halo rows on each side, reading only the CTA's own buffer (the
  emulation hands each CTA nothing else); after the last iteration the
  strip's first and last S rows go into the inboxes of the CTAs above and
  below; the last batch is clipped at max_iters;
- before every iteration, each cell the iteration must write (the
  foreground of its rows) is poisoned with 0, which wins every minimum, and
  so is every inbox cell a batch must send, so a missing write or send
  shows in the result; background cells and the outer halo rows keep the
  background from the start;
- every CTA of a mask stops after the first batch in which no pixel of the
  mask changed (it started from the fixed point), or at max_iters.

Shapes from a single row or column up to 255x255; masks made with numpy
from seeds.
"""

import math
import re

import numpy as np
import pytest
import torch

from video_classification_tpu_torch.ops.component_extents import (
    CLUSTER, ITERS_PER_SYNC, MAX_SIDE, component_extents_reference)
from video_classification_tpu_torch.pipeline.online import SyntheticOnlineDetector
from video_classification_tpu_torch.config.crop_cfg import crop_part_args
from video_classification_tpu_torch.ops.components import part_mask
from video_classification_tpu_torch.utils import cuda
from torch_port_support import one_torch_thread  # noqa: F401  (autouse)

SOURCE = (cuda.CSRC / "component_extents.cu").read_text()
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SOURCE)}
BG = 0xFF
MAX_SMEM = 232448  # dynamic shared memory of one H100 block
INT32_MAX = 2 ** 31 - 1


def launchable(h, w):
    """The kernel's launch check: two Jacobi buffers of (rows + 2 S) rows
    and two inbox parities of 2 S rows, of 4-byte words, rows padded to 32
    words, in one block's shared memory."""
    rows = -(-h // CLUSTER)
    S = min(ITERS_PER_SYNC, rows)
    stride = -(-w // 32) * 32
    return (2 * (rows + 2 * S) + 4 * S) * stride * 4 <= MAX_SMEM


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
    """One (H, W) mask by the kernel's schedule; the four int32 fields and
    the iterations run. The CTAs are a leading dimension; a strip past the
    mask's last row is background (the kernel's short last strip and its
    empty neighbours hold only background there too)."""
    h, w = mask.shape
    c = CLUSTER
    rows = -(-h // c)
    S = min(ITERS_PER_SYNC, rows)
    pad = torch.zeros((c * rows, w), dtype=torch.bool)
    pad[:h] = mask
    fg = pad.view(c, rows, w, 1)
    bufs = torch.full((c, 2, rows + 2 * S, w, 4), BG, dtype=torch.int32)
    inbox = torch.full((c, 2, 2 * S, w, 4), BG, dtype=torch.int32)

    def push(par, new):
        """The strip's first S rows into the inbox below-part of the CTA
        above, its last S rows into the above-part of the CTA below."""
        up, first = inbox[:-1, par, S:], fg[1:, :S]
        inbox[:-1, par, S:] = torch.where(first, new[1:, :S], up)
        down, last = inbox[1:, par, :S], fg[:-1, rows - S:]
        inbox[1:, par, :S] = torch.where(last, new[:-1, rows - S:], down)

    words = encode(pad).view(c, rows, w, 4).to(torch.int32)
    bufs[:, 0, S:S + rows] = words
    push(0, words)
    cur, done, batch = 0, 0, 0
    while done < max_iters:
        steps = min(S, max_iters - done)
        par = batch & 1
        bufs[:, cur, :S] = inbox[:, par, :S]
        bufs[:, cur, S + rows:] = inbox[:, par, S:]
        # Poison what this batch must push (only the last iteration does).
        push(1 - par, torch.zeros_like(words))
        changed = False
        for step in range(1, steps + 1):
            k = steps - step  # halo rows still updated on each side
            lo, hi = S - k, S + rows + k
            src, dst = bufs[:, cur], bufs[:, 1 - cur]
            old = src[:, lo:hi]
            live = old != BG
            # Poison what this iteration must write: its region's foreground.
            dst[:, lo:hi] = torch.where(live, torch.zeros_like(old), dst[:, lo:hi])
            v = torch.minimum(torch.minimum(src[:, lo - 1:hi - 1], old), src[:, lo + 1:hi + 1])
            edge = torch.full_like(v[:, :, :1], BG)
            left = torch.cat([edge, v[:, :, :-1]], 2)
            right = torch.cat([v[:, :, 1:], edge], 2)
            new = torch.where(live, torch.minimum(torch.minimum(left, v), right), old)
            dst[:, lo:hi] = new
            strip = new[:, k:k + rows]
            changed |= not torch.equal(strip, old[:, k:k + rows])
            if step == steps:
                push(1 - par, strip)
            cur = 1 - cur
        done += steps
        batch += 1
        if not changed:
            break
    return decode(bufs[:, cur, S:S + rows].reshape(c * rows, w, 4)[:h]), done


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


def _check(m, max_iters=None):
    h, w = m.shape
    max_iters = h + w if max_iters is None else max_iters
    mask = torch.from_numpy(np.ascontiguousarray(m))
    want = component_extents_reference(mask[None], max_iters)
    got, _ = cluster_extents(mask, max_iters)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt[0])


SHAPES = [(1, 37), (29, 1), (13, 17), (57, 76), (112, 112), (255, 255)]
KINDS = ["random", "sparse", "empty", "charts", "serpentine", "serpentine_vertical"]


def test_constants_match_the_source():
    assert CONSTS["kMaxSide"] == MAX_SIDE == 255
    assert CONSTS["kCluster"] == CLUSTER and 1 < CLUSTER <= 8  # a portable cluster size
    assert CONSTS["kItersPerSync"] == ITERS_PER_SYNC >= 1
    assert "s.rows = (H + kCluster - 1) / kCluster;" in SOURCE
    assert "s.S = std::min(kItersPerSync, s.rows);" in SOURCE
    assert "s.smem = (size_t)(2 * (s.rows + 2 * s.S) + 4 * s.S) * stride * 4;" in SOURCE
    # The cluster takes every mask up to 255x255.
    assert launchable(MAX_SIDE, MAX_SIDE)


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
