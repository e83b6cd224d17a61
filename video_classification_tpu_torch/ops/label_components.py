"""Connected-component labels of masks: CUDA kernel K6 and its plain twin.

``label_components`` replaces the JAX package's Pallas kernel
``ops/pallas_components.py::_cc_kernel`` (entry ``label_components_pallas``)
and the XLA loop of ``ops/components.py::label_components``: every
foreground pixel gets the minimum row-major index r * W + c of its
8-connected component, background gets INT32_MAX. Labels propagate by
Jacobi min-pooling over the 8 neighbours, masked to the foreground, until
nothing changes or ``max_iters`` (default H + W) rounds ran. Each mask stops
at its own fixed point, which further rounds would not change, so the
result equals the Pallas kernel's fixed H + W rounds. See
``csrc/label_components.cu`` and ``csrc/cluster_strips.cuh`` for the design
on Hopper: the propagation of the component extents (K2) with int32 labels
for words, on a thread-block cluster per mask when its strips fit the
cluster's shared memory (240x320 does), else in device memory.

``label_components_reference`` is the JAX package's XLA loop with plain
tensor ops: the CPU path and the kernel's oracle on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import cuda
from .component_extents import INT32_MAX, _pool


def label_components(masks: torch.Tensor,
                     max_iters: Optional[int] = None) -> torch.Tensor:
    """(B, H, W) bool/int masks -> (B, H, W) int32 labels.

    CPU tensors run ``label_components_reference``; CUDA tensors launch the
    kernel (and raise if it cannot build or launch)."""
    if masks.dim() != 3:
        raise ValueError(f"masks must be (B, H, W), got {tuple(masks.shape)}")
    b, h, w = masks.shape
    if h * w >= INT32_MAX:
        raise ValueError(f"{h}x{w} masks have more pixels than int32 labels")
    if max_iters is None:
        max_iters = h + w
    if masks.device.type == "cpu":
        return label_components_reference(masks, max_iters)
    out = cuda.build().label_components(masks, int(max_iters))
    label_components.launches += 1
    return out


label_components.launches = 0


def label_components_reference(masks: torch.Tensor,
                               max_iters: Optional[int] = None) -> torch.Tensor:
    """The kernel's propagation with plain tensor ops (any device).

    All masks iterate together until none changes; a converged mask is a
    fixed point, so extra rounds leave it as it is."""
    b, h, w = masks.shape
    if max_iters is None:
        max_iters = h + w
    fg = masks != 0
    dev = masks.device
    lin = torch.arange(h * w, dtype=torch.int32, device=dev).view(1, h, w)
    inf = torch.full((b, h, w), INT32_MAX, dtype=torch.int32, device=dev)
    labels = torch.where(fg, lin, inf)
    for _ in range(max_iters):
        new = torch.where(fg, _pool(labels, torch.minimum, INT32_MAX), inf)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels
