"""Clip samplers.

The reference's two sampling policies (chalearn_dataset.py:123-140), copied
from the JAX package so the same seed gives the same indices (host side,
Python ``random``):

  * random: one contiguous CLIP_LEN window with a uniformly random start in
    [0, max(0, seq_len - clip_len)]; a video shorter than the clip wraps
    around via ``i % seq_len``.
  * uniform: sliding windows with stride 4 over [0, seq_len - clip_len); a
    short video yields a single random (wraparound) clip.

The device versions take ``seq_len`` as a tensor and return index tensors on
its device: the random window's start drawn from an explicit
``torch.Generator``, the uniform windows as a fixed (max_clips, clip_len)
array with a mask of the real ones.
"""

from __future__ import annotations

import random as _pyrandom
from typing import List, Tuple

import torch

UNIFORM_STRIDE = 4  # chalearn_dataset.py:137


def random_clip_indices(seq_len: int, clip_len: int, rng: _pyrandom.Random) -> List[int]:
    possible_start = max(0, seq_len - clip_len)
    start = rng.randint(0, possible_start)  # both ends inclusive
    return [i % seq_len for i in range(start, start + clip_len)]


def uniform_clip_indices(seq_len: int, clip_len: int, rng: _pyrandom.Random) -> List[List[int]]:
    if seq_len <= clip_len:
        return [random_clip_indices(seq_len, clip_len, rng)]
    return [
        list(range(t, t + clip_len))
        for t in range(0, seq_len - clip_len, UNIFORM_STRIDE)
    ]


def num_uniform_clips(seq_len: int, clip_len: int) -> int:
    if seq_len <= clip_len:
        return 1
    return len(range(0, seq_len - clip_len, UNIFORM_STRIDE))


def random_clip_indices_device(generator: torch.Generator, seq_len: torch.Tensor,
                               clip_len: int) -> torch.Tensor:
    """(clip_len,) int32 indices on ``seq_len``'s device: a window start
    uniform in [0, max(0, seq_len - clip_len)] drawn from ``generator`` (on
    that device), wrapping around a video shorter than the clip."""
    seq_len = torch.as_tensor(seq_len, dtype=torch.int32)
    dev = seq_len.device
    possible = torch.clamp(seq_len - clip_len, min=0)
    u = torch.rand((), generator=generator, device=dev, dtype=torch.float64)
    start = torch.minimum((u * (possible + 1).double()).floor().to(torch.int32), possible)
    idx = start + torch.arange(clip_len, dtype=torch.int32, device=dev)
    return idx % torch.clamp(seq_len, min=1)


def uniform_clip_indices_device(seq_len: torch.Tensor, clip_len: int, max_clips: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (max_clips, clip_len) int32, mask (max_clips,) bool) on
    ``seq_len``'s device: windows at stride 4, the first ``n`` real, where
    ``n`` = ``num_uniform_clips``; a short video gives one window starting at
    0 that wraps around."""
    seq_len = torch.as_tensor(seq_len, dtype=torch.int32)
    dev = seq_len.device
    starts = torch.arange(max_clips, dtype=torch.int32, device=dev) * UNIFORM_STRIDE
    n_real = torch.where(seq_len <= clip_len, torch.ones_like(seq_len),
                         torch.clamp(-torch.div(clip_len - seq_len, UNIFORM_STRIDE,
                                                rounding_mode="floor"), min=1))
    mask = torch.arange(max_clips, device=dev) < n_real
    idx = starts[:, None] + torch.arange(clip_len, dtype=torch.int32, device=dev)[None, :]
    return idx % torch.clamp(seq_len, min=1), mask
