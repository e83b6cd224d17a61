"""Clip samplers (host side, Python ``random``).

The reference's two sampling policies (chalearn_dataset.py:123-140), copied
from the JAX package so the same seed gives the same indices:

  * random: one contiguous CLIP_LEN window with a uniformly random start in
    [0, max(0, seq_len - clip_len)]; a video shorter than the clip wraps
    around via ``i % seq_len``.
  * uniform: sliding windows with stride 4 over [0, seq_len - clip_len); a
    short video yields a single random (wraparound) clip.
"""

from __future__ import annotations

import random as _pyrandom
from typing import List

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
