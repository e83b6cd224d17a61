"""The one traffic generator: every mix is a data file of parameters it reads.

Serving mixes (``"kind": "serve"``): closed-loop requests of synthetic RGB +
depth videos, ``variants`` videos of each raw length of ``lengths``. A cycle
serves every one of them once, in an order shuffled per cycle by the seed,
so every run sees the same lengths in the same proportions and a run of
whole cycles does the same work whatever the seed.

A video is coherent motion (the program's ``utils/synthetic``
``coherent_motion_frames``, frozen here and widened): a textured Gaussian
blob moving at ``speed`` px a frame over a static random background, so
the flow solver finds real motion; the blob reflects at the frame's edges,
so a long video has motion in every frame. Background, start and texture
phase come from the seed. Depth is the frame's grey level.

Training mixes (``"kind": "train"``): a stream of ``pool`` distinct
in-memory clips (uniform random uint8, the 21 channels of a crop stream)
with uniform labels, handed out in the order they are asked for.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def _reflect(p0: float, step: float, lo: float, hi: float, t: torch.Tensor) -> torch.Tensor:
    span = hi - lo
    q = torch.remainder(p0 - lo + step * t, 2 * span)
    return lo + torch.where(q <= span, q, 2 * span - q)


def coherent_motion_frames(t: int, h: int, w: int, generator: torch.Generator,
                           speed=(1.5, 2.5), blob: float = 0.08,
                           texture=(0.7, 0.9)) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames on the generator's device."""
    dev = generator.device
    bg = torch.rand((h, w, 3), generator=generator, device=dev) * 0.5 + 0.25
    start = torch.rand((2,), generator=generator, device=dev).tolist()
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ti = torch.arange(t, dtype=torch.float32, device=dev)
    ry, rx = h * blob, w * blob
    cy = _reflect(ry + start[0] * (h - 2 * ry), speed[0], ry, h - ry, ti)[:, None, None]
    cx = _reflect(rx + start[1] * (w - 2 * rx), speed[1], rx, w - rx, ti)[:, None, None]
    g = torch.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))
    tex = 0.5 + 0.5 * torch.sin(texture[0] * (yy - cy)) * torch.sin(texture[1] * (xx - cx))
    fr = bg[None] * (1.0 - g[..., None]) + (tex * g)[..., None]
    return (fr * 255.0).to(torch.uint8)


def video(seed: int, frames: int, mix: Dict, device) -> Tuple[np.ndarray, np.ndarray]:
    """(rgb (T, H, W, 3), depth (T, H, W, 1)) uint8 host arrays of one video."""
    g = torch.Generator(device).manual_seed(int(seed))
    rgb = coherent_motion_frames(frames, mix["height"], mix["width"], g,
                                 mix["speed"], mix["blob"], mix["texture"])
    depth = rgb.float().mean(-1, keepdim=True).to(torch.uint8)
    return rgb.cpu().numpy(), depth.cpu().numpy()


def video_seed(seed: int, length: int, variant: int) -> int:
    return (int(seed) * 1_000_003 + length * 1009 + variant) % (2 ** 63)


class ServeTraffic:
    """The requests of a serving mix: ``videos[(length, variant)]`` made in
    set-up, ``requests()`` the endless closed-loop sequence of (length,
    variant) keys, each key once in each cycle of ``cycle`` requests."""

    def __init__(self, mix: Dict, seed: int, device):
        self.mix = mix
        self.seed = int(seed)
        self.lengths: List[int] = list(mix["lengths"])
        self.keys = [(n, v) for n in self.lengths for v in range(mix["variants"])]
        self.cycle = len(self.keys)
        self.videos = {key: video(video_seed(seed, *key), key[0], mix, device)
                       for key in self.keys}

    def requests(self) -> Iterator[Tuple[int, int]]:
        c = 0
        while True:
            order = list(self.keys)
            random.Random(self.seed * 7919 + c).shuffle(order)
            yield from order
            c += 1


class ClipStream:
    """The training mix's dataset: ``len`` clips, each request for a clip
    (``get_train_clip``, whatever index and generator it is given) handed the
    next of ``pool`` distinct clips and labels, in order, around the pool."""

    def __init__(self, mix: Dict, shape, classes: int, seed: int, device):
        g = torch.Generator(device).manual_seed(int(seed))
        n = int(mix["pool"])
        self.clips = torch.randint(0, 256, (n, *shape), generator=g, device=device,
                                   dtype=torch.uint8).cpu().numpy()
        self.labels = torch.randint(0, classes, (n,), generator=g, device=device).cpu().numpy()
        self.length = int(mix["epoch_clips"])
        self.handed = 0

    def __len__(self) -> int:
        return self.length

    def get_train_clip(self, index: int, rng) -> Dict:
        k = self.handed % len(self.clips)
        self.handed += 1
        return {"x": self.clips[k], "label": int(self.labels[k])}
