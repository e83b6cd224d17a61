"""Per-pixel connected-component extents: CUDA kernel K2 and its plain twin.

``component_extents`` replaces the JAX package's Pallas kernel
``ops/pallas_components.py::_ext_kernel`` (entry
``component_extents_pallas``): for each (H, W) mask, every foreground pixel
gets its 8-connected component's (min_row, max_row, min_col, max_col), by
masked min/max propagation (Jacobi) until nothing changes, at most H + W
iterations; background gets (INT32_MAX, -1, INT32_MAX, -1). See
``csrc/component_extents.cu`` and ``csrc/cluster_strips.cuh`` for the design
on Hopper: a thread-block cluster of ``CLUSTER`` CTAs per mask, each owning a
strip of rows, ``ITERS_PER_SYNC`` iterations between halo exchanges (both
fixed when the kernel is compiled); masks up to ``NARROW_SIDE`` on each side
pack the four fields as bytes of one word, larger ones (up to ``MAX_SIDE``)
as 16-bit fields in two passes of one word each, rows then columns. Masks
whose strips do not fit a cluster's shared memory take a device-memory
route of one launch per iteration.

``component_extents_reference`` is the same propagation with plain tensor
ops: the CPU path and the kernel's oracle on the card.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ..utils import cuda
from ..utils.profiling import span

INT32_MAX = 2 ** 31 - 1
NARROW_SIDE = 255  # the byte fields' limit (csrc/component_extents.cu kNarrowSide)
MAX_SIDE = 65534  # the 16-bit fields' limit (kMaxSide)
CLUSTER = 4  # CTAs per mask (csrc/cluster_strips.cuh kCluster)
ITERS_PER_SYNC = 4  # iterations per halo exchange, at most (kItersPerSync)

Extents = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def component_extents(masks: torch.Tensor,
                      max_iters: Optional[int] = None) -> Extents:
    """(B, H, W) bool/int masks -> 4 x (B, H, W) int32 extents.

    CPU tensors run ``component_extents_reference``; CUDA tensors launch the
    kernel (and raise if it cannot build or launch, or a side exceeds
    ``MAX_SIDE``)."""
    if masks.dim() != 3:
        raise ValueError(f"masks must be (B, H, W), got {tuple(masks.shape)}")
    b, h, w = masks.shape
    if max_iters is None:
        max_iters = h + w
    with span("kernel::component_extents"):
        if masks.device.type == "cpu":
            return component_extents_reference(masks, max_iters)
        if max(h, w) > MAX_SIDE:
            raise ValueError(f"{h}x{w} masks exceed the kernel's 16-bit fields "
                             f"(sides up to {MAX_SIDE})")
        outs = cuda.build().component_extents(masks, int(max_iters))
    component_extents.launches += 1
    return tuple(outs)


component_extents.launches = 0


def _pool(x: torch.Tensor, op, fill: int) -> torch.Tensor:
    """op over each pixel and its 8 neighbours; ``fill`` outside the mask."""
    b, h, w = x.shape
    p = torch.full((b, h + 2, w + 2), fill, dtype=x.dtype, device=x.device)
    p[:, 1:-1, 1:-1] = x
    n = x
    for dy, dx in ((0, 1), (2, 1), (1, 0), (1, 2),
                   (0, 0), (0, 2), (2, 0), (2, 2)):
        n = op(n, p[:, dy:dy + h, dx:dx + w])
    return n


def component_extents_rounds(masks: torch.Tensor) -> Iterator[Extents]:
    """The plain propagation one round at a time: the extents before the
    first round, then after each round, ending with the first round that
    changes nothing (every mask at its fixed point)."""
    b, h, w = masks.shape
    fg = masks != 0
    dev = masks.device
    rows = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1).expand(b, h, w)
    cols = torch.arange(w, dtype=torch.int32, device=dev).view(1, 1, w).expand(b, h, w)
    inf = torch.full((b, h, w), INT32_MAX, dtype=torch.int32, device=dev)
    neg = torch.full((b, h, w), -1, dtype=torch.int32, device=dev)
    state = (torch.where(fg, rows, inf), torch.where(fg, rows, neg),
             torch.where(fg, cols, inf), torch.where(fg, cols, neg))
    yield state
    while True:
        new = (torch.where(fg, _pool(state[0], torch.minimum, INT32_MAX), inf),
               torch.where(fg, _pool(state[1], torch.maximum, -1), neg),
               torch.where(fg, _pool(state[2], torch.minimum, INT32_MAX), inf),
               torch.where(fg, _pool(state[3], torch.maximum, -1), neg))
        changed = any(bool((n != s).any()) for n, s in zip(new, state))
        state = new
        yield state
        if not changed:
            return


def component_extents_reference(masks: torch.Tensor,
                                max_iters: Optional[int] = None) -> Extents:
    """The kernel's propagation with plain tensor ops (any device).

    All masks iterate together until none changes; a converged mask is a
    fixed point, so extra iterations leave it as it is."""
    if max_iters is None:
        max_iters = masks.shape[1] + masks.shape[2]
    for k, state in enumerate(component_extents_rounds(masks)):
        if k == max_iters:
            break
    return state
