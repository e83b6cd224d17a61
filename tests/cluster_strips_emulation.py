"""The schedule of ``csrc/cluster_strips.cuh``, emulated with plain tensor ops.

The kernels run only on the card. The CPU tests of K2
(``test_torch_port_extents_cluster.py``) and K6
(``test_torch_port_label_cluster.py``) replay their propagation here, with
the header's constants read from its source, and hold the result
``torch.equal`` to the plain twins. A word is a vector of L lanes (the
kernel's fields; every policy's minimum is lane-wise), background ``bg`` in
every lane.

The cluster route (``cluster_run``):

- a cluster of C = kCluster CTAs per mask and pass; CTA r owns rows
  [r * rows, (r + 1) * rows), rows = ceil(H / C), in two Jacobi buffers of
  (rows + 2 S) x W words, the strip with S = min(kItersPerSync, rows) halo
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

The device-memory route (``device_run``): two whole-mask buffers, one
iteration per launch reading one and writing the other (its foreground
poisoned with 0 first), skipped once an iteration changed nothing; the
result is read from the buffer of iteration max_iters.
"""

import re

import torch

from video_classification_tpu_torch.utils import cuda

HEADER = (cuda.CSRC / "cluster_strips.cuh").read_text()
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", HEADER)}
CLUSTER = CONSTS["kCluster"]
ITERS_PER_SYNC = CONSTS["kItersPerSync"]
MAX_SMEM = CONSTS["kMaxSmem"]
STATIC_SMEM = 2 * 8 + 2 * CLUSTER * 4  # the header's kStaticSmem: mbarriers, votes


def strip_shape(h, w):
    """(rows, S, stride) of the cluster route: rows per CTA, iterations per
    exchange, the row pitch in words (W rounded up to 32)."""
    rows = -(-h // CLUSTER)
    return rows, min(ITERS_PER_SYNC, rows), -(-w // 32) * 32


def fits_cluster(h, w, max_chunks):
    """The header's ``fits_cluster``: rows of at most ``max_chunks`` chunks
    of 32 words, and two Jacobi buffers of (rows + 2 S) rows and two inbox
    parities of 2 S rows of 4-byte words in one block's shared memory."""
    rows, S, stride = strip_shape(h, w)
    smem = (2 * (rows + 2 * S) + 4 * S) * stride * 4
    return stride // 32 <= max_chunks and smem + STATIC_SMEM <= MAX_SMEM


def _minimum3x3(src, lo, hi):
    """The 3x3 minimum of rows [lo, hi) of ``src`` (..., rows, W + 2, L),
    whose first and last columns hold the background: the vertical minimum
    from the rows above and below, then the horizontal one."""
    v = torch.minimum(torch.minimum(src[..., lo - 1:hi - 1, :, :], src[..., lo:hi, :, :]),
                      src[..., lo + 1:hi + 1, :, :])
    return torch.minimum(torch.minimum(v[..., :-2, :], v[..., 1:-1, :]), v[..., 2:, :])


def cluster_run(words, bg, max_iters):
    """(H, W, L) words of one mask and pass (background ``bg`` in
    every lane) by the cluster route; the final words and the iterations
    run. The CTAs are a leading dimension; a strip past the mask's last row
    is background (the kernel's short last strip and its empty neighbours
    hold only background there too), and so are a column on each side of
    the rows."""
    h, w, lanes = words.shape
    c = CLUSTER
    rows, S, _ = strip_shape(h, w)
    pad = torch.full((c * rows, w, lanes), bg, dtype=torch.int32)
    pad[:h] = words
    words = pad.view(c, rows, w, lanes)
    fg = words != bg
    bufs = torch.full((c, 2, rows + 2 * S, w + 2, lanes), bg, dtype=torch.int32)
    inbox = torch.full((c, 2, 2 * S, w, lanes), bg, dtype=torch.int32)

    def push(par, new):
        """The strip's first S rows into the inbox below-part of the CTA
        above, its last S rows into the above-part of the CTA below."""
        up, first = inbox[:-1, par, S:], fg[1:, :S]
        inbox[:-1, par, S:] = torch.where(first, new[1:, :S], up)
        down, last = inbox[1:, par, :S], fg[:-1, rows - S:]
        inbox[1:, par, :S] = torch.where(last, new[:-1, rows - S:], down)

    bufs[:, 0, S:S + rows, 1:-1] = words
    push(0, words)
    cur, done, batch = 0, 0, 0
    while done < max_iters:
        steps = min(S, max_iters - done)
        par = batch & 1
        bufs[:, cur, :S, 1:-1] = inbox[:, par, :S]
        bufs[:, cur, S + rows:, 1:-1] = inbox[:, par, S:]
        # Poison what this batch must push (only the last iteration does).
        push(1 - par, torch.zeros_like(words))
        changed = False
        for step in range(1, steps + 1):
            k = steps - step  # halo rows still updated on each side
            lo, hi = S - k, S + rows + k
            src, dst = bufs[:, cur], bufs[:, 1 - cur, lo:hi, 1:-1]
            old = src[:, lo:hi, 1:-1]
            live = old != bg  # a foreground word has no background lane
            # Poison what this iteration must write: its region's foreground.
            dst.masked_fill_(live, 0)
            new = torch.where(live, _minimum3x3(src, lo, hi), old)
            dst.copy_(new)
            strip = new[:, k:k + rows]
            changed |= not torch.equal(strip, old[:, k:k + rows])
            if step == steps:
                push(1 - par, strip)
            cur = 1 - cur
        done += steps
        batch += 1
        if not changed:
            break
    return bufs[:, cur, S:S + rows, 1:-1].reshape(c * rows, w, lanes)[:h], done


def device_run(words, bg, max_iters):
    """(H, W, L) words of one mask and pass by the device-memory
    route; the final words and the iterations run."""
    h, w, lanes = words.shape
    bufs = torch.full((2, h + 2, w + 2, lanes), bg, dtype=torch.int32)
    bufs[:, 1:-1, 1:-1] = words
    fg = words != bg
    flag, ran = True, 0
    for k in range(max_iters):
        if not flag:
            continue  # the launch returns: the mask reached its fixed point
        src, dst = bufs[k & 1], bufs[1 - (k & 1), 1:-1, 1:-1]
        dst.masked_fill_(fg, 0)
        dst.copy_(torch.where(fg, _minimum3x3(src, 1, h + 1), src[1:-1, 1:-1]))
        flag = not torch.equal(dst, src[1:-1, 1:-1])
        ran += 1
    return bufs[max(max_iters, 0) & 1, 1:-1, 1:-1], ran
