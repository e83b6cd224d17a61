"""Synthetic video with coherent motion, made from a seeded generator."""

from __future__ import annotations

from typing import Optional

import torch


def coherent_motion_frames(t: int, h: int, w: int,
                           generator: Optional[torch.Generator] = None,
                           device=None) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames: a textured blob translating ~3 px/frame.

    A Gaussian blob carrying a sinusoidal texture (locked to the blob, so it
    translates with it) moves diagonally over a static random background, so
    the flow solver recovers real nonzero flow on consecutive pairs. The
    background is drawn on the CPU from ``generator`` (seed 0 if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    bg = torch.rand((h, w, 3), generator=generator) * 0.5 + 0.25
    bg = bg.to(device)
    yy = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    t_idx = torch.arange(t, dtype=torch.float32, device=device)
    cy = (h * 0.3 + 1.5 * t_idx)[:, None, None]
    cx = (w * 0.25 + 2.5 * t_idx)[:, None, None]
    blob = torch.exp(-(((yy - cy) / (h * 0.08)) ** 2 + ((xx - cx) / (w * 0.08)) ** 2))
    tex = 0.5 + 0.5 * torch.sin(0.7 * (yy - cy)) * torch.sin(0.9 * (xx - cx))
    fr = bg[None] * (1.0 - blob[..., None]) + (tex * blob)[..., None]
    return (fr * 255.0).to(torch.uint8)
