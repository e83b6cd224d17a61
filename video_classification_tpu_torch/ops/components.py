"""Largest connected-component bounding box of part masks.

Port of the JAX package's ``ops/components.py``: the reference's
findContours -> boundingRect -> largest area -> reject < 15 px chain
(chalearn_iuv_to_crop.py:114-149) as per-pixel component extents (kernel K2,
``ops/component_extents.py``) followed by an argmax of the per-pixel bbox
area. The max over pixels equals the max over components, and the argmax's
first-maximum tie-break picks the component whose first (row-major) pixel
comes first. Batched over a leading mask dimension; on CUDA any side up to
``component_extents.MAX_SIDE`` (65534), on the CPU any size.

``label_components`` (kernel K6, ``ops/label_components.py``) is re-exported
here, where the JAX package has it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .component_extents import component_extents
from .label_components import label_components  # noqa: F401  (re-export)

MIN_PART_SIZE = 15  # chalearn_iuv_to_crop.py:148


def largest_component_bbox(masks: torch.Tensor, min_size: int = MIN_PART_SIZE
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) masks -> (bbox (B, 4) int32 xywh, valid (B,) bool).

    A mask with no foreground, or whose best box is narrower or shorter than
    ``min_size``, is invalid and gets a zero box. ``min_size=0`` leaves the
    size rule to the caller (the device pipeline applies it in pixels)."""
    b = masks.shape[0]
    mnr, mxr, mnc, mxc = component_extents(masks)
    zero = torch.zeros_like(mnr)
    widths = torch.where(mxc >= 0, mxc - mnc + 1, zero).reshape(b, -1)
    heights = torch.where(mxr >= 0, mxr - mnr + 1, zero).reshape(b, -1)
    areas = widths * heights
    best = torch.argmax(areas, dim=1, keepdim=True)

    def pick(t):
        return torch.gather(t.reshape(b, -1), 1, best)[:, 0]

    bw, bh = pick(widths), pick(heights)
    bbox = torch.stack([pick(mnc), pick(mnr), bw, bh], dim=1).to(torch.int32)
    valid = (pick(areas) > 0) & (bw >= min_size) & (bh >= min_size)
    bbox = torch.where(valid[:, None], bbox, torch.zeros_like(bbox))
    return bbox, valid


def part_mask(charts: torch.Tensor, part_indices: Sequence[int]) -> torch.Tensor:
    """OR of (I == pid) over a part-index group (chalearn_iuv_to_crop.py:114-119)."""
    m = torch.zeros(charts.shape, dtype=torch.bool, device=charts.device)
    for pid in part_indices:
        m = m | (charts == pid)
    return m
