"""Network FLOPs of a clip, counted on the reference network.

``torch.utils.flop_counter.FlopCounterMode`` over the reference SlowFast's
forward (``reference.slowfast``) on meta tensors: the convolutions' and the
head's multiply-adds, two FLOPs each, from the shapes alone, whatever
implements them. One slowfast-HTAH clip (1 x 20 x 192 x 192, 249 classes,
depth 50) reads 170.737 GFLOP.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.crops import PARTS
from ..reference.slowfast import SlowFast


def crop_size(folder: str) -> int:
    """The square side a crop stream's clips are resized to."""
    return PARTS[folder][1]


@functools.lru_cache(maxsize=None)
def clip_flops(classes: int, depth: int, clip_len: int, size: int) -> float:
    """Forward FLOPs of one (clip_len, size, size) clip."""
    with torch.device("meta"):
        model = SlowFast(classes, depth).eval()
        xs = [torch.empty(1, 5, clip_len, size, size), torch.empty(1, 15, clip_len, size, size)]
        with FlopCounterMode(display=False) as counter:
            model(xs)
    return float(counter.get_total_flops())
