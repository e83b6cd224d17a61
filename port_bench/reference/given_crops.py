"""Plain PyTorch body-part crops from given detections (reference copy).

``reference.crops.window_crops`` makes a window's crops behind the synthetic
detector; here the detections are given, as a detector returns them per
sampled frame: the body box (xyxy in the 2x-padded frame), whether it is
valid, and the part chart and its U/V at any heatmap size (DensePose R-CNN's
112 x 112 with a 28-px pooler). The steps are those of
``reference.crops``: the 21-channel canvas aligned on the box, per part
group the largest 8-connected component of the part's chart mask scaled
from the heatmap to the box in pixels, a box under 15 px or an invalid
detection counted as missing (127), centred in a square and resized by
OpenCV's bicubic kernel. ``video_clips`` is ``reference.serve.video_clips``
with the detections of each window given. Every matrix product is float32
(TF32 off).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import flow
from .crops import (MIN_PART_SIZE, MISSING_FILL, PARTS, _uv_to_canvas, largest_component_box,
                    pad2x, shift2d, square_resize)
from .precision import strict_float32
from .serve import window_indices

# (boxes (S, 4), valid (S,), charts (S, hm, hm), uv (S, 2, hm, hm))
Detections = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


@strict_float32()
def window_crops(frames: torch.Tensor, depth: torch.Tensor, flow_images: torch.Tensor,
                 folders: Sequence[str], detections: Detections,
                 interval: int = 5) -> Dict[str, torch.Tensor]:
    """{folder: (S, size, size, 21) uint8} of one window, as
    ``reference.crops.window_crops``, with the sampled frames' ``detections``."""
    n, h, w = frames.shape[:3]
    dev = frames.device
    sampled = torch.arange(interval, n, interval, device=dev)
    s = sampled.shape[0]
    boxes, valid, charts, uv = (t.to(dev) for t in detections)
    hm = charts.shape[-1]
    flow_idx = sampled[:, None] + torch.arange(-interval + 1, 1, device=dev)[None, :]
    flows = pad2x(flow_images[flow_idx.reshape(-1)]).reshape(s, interval, 2 * h, 2 * w, 3)
    flows = flows.permute(0, 2, 3, 1, 4).reshape(s, 2 * h, 2 * w, 3 * interval)
    stacked = torch.cat([pad2x(frames[sampled]), flows, pad2x(depth[sampled])], -1)
    x1, y1, x2, y2 = boxes.to(torch.int32).unbind(-1)
    bh, bw = torch.clamp(y2 - y1, min=1), torch.clamp(x2 - x1, min=1)
    body = shift2d(stacked, y1, x1, (2 * h, 2 * w))
    u, v = _uv_to_canvas(uv.float(), bh, bw, (2 * h, 2 * w))
    u8 = torch.clamp(u * 256.0, 0, 255).to(torch.uint8)[..., None]
    v8 = torch.clamp(v * 256.0, 0, 255).to(torch.uint8)[..., None]
    canvas = torch.cat([body[..., :3], u8, v8, body[..., 3:]], -1)
    out = {}
    for folder in folders:
        part, size = PARTS[folder]
        mask = torch.zeros(charts.shape, dtype=torch.bool, device=dev)
        for pid in part:
            mask |= charts == pid
        clips = []
        boxes_of = {}
        for i in range(s):
            key = mask[i].cpu().numpy().tobytes()
            if key not in boxes_of:
                boxes_of[key] = largest_component_box(mask[i])
            hx, hy, hw_, hh, found = boxes_of[key]
            sx, sy = float(bw[i]) / hm, float(bh[i]) / hm
            px, py = int(np.float32(hx) * np.float32(sx)), int(np.float32(hy) * np.float32(sy))
            pw = max(int(np.float32(hw_) * np.float32(sx)), 1)
            ph = max(int(np.float32(hh) * np.float32(sy)), 1)
            ok = found and pw >= MIN_PART_SIZE and ph >= MIN_PART_SIZE and bool(valid[i])
            if not ok:
                clips.append(torch.full((size, size, 21), float(MISSING_FILL), device=dev))
                continue
            pw, ph = min(pw, w), min(ph, h)
            window = shift2d(canvas[i:i + 1], torch.tensor([py]), torch.tensor([px]), (h, w))[0]
            clips.append(square_resize(window.float(), ph, pw, size))
        out[folder] = torch.clamp(torch.round(torch.stack(clips)), 0, 255).to(torch.uint8)
    return out


def sampled_frames(window: np.ndarray, interval: int) -> np.ndarray:
    """The raw frames of a window's sampled frames (positions interval,
    2 x interval, ...)."""
    return window[interval::interval]


@strict_float32()
def video_clips(rgb: torch.Tensor, depth: torch.Tensor, folders: Sequence[str],
                detections_of: Callable[[np.ndarray], Detections], clip_len: int = 20,
                interval: int = 5, params: flow.FlowParams = flow.FlowParams(), spent=None,
                window_flows: Optional[List[torch.Tensor]] = None,
                quant=flow.F32) -> Dict[str, torch.Tensor]:
    """``reference.serve.video_clips`` with given detections:
    ``detections_of(raw)`` returns the ``Detections`` of the raw frames
    ``raw`` (a window's sampled frames, in order)."""
    windows = window_indices(rgb.shape[0], clip_len, interval)
    pairs = sorted({(int(w[j - 1]), int(w[j])) for w in windows for j in range(1, len(w))})
    t0 = time.perf_counter()
    images = flow.pair_flows(rgb, torch.tensor(pairs), params, quant=quant)
    if spent is not None:
        images.cpu()
        t1 = time.perf_counter()
        spent["flow"] = spent.get("flow", 0.0) + t1 - t0
    where = {pr: i for i, pr in enumerate(pairs)}
    out: Dict[str, list] = {f: [] for f in folders}
    for w in windows:
        rows = [0] + [where[(int(w[j - 1]), int(w[j]))] for j in range(1, len(w))]
        idx = torch.from_numpy(w).to(rgb.device)
        made = window_crops(rgb[idx], depth[idx], images[torch.tensor(rows)], folders,
                            detections_of(sampled_frames(w, interval)), interval)
        if window_flows is not None:
            window_flows.append(images[torch.tensor(rows[1:])])
        for f in folders:
            out[f].append(made[f])
    clips = {f: torch.stack(v) for f, v in out.items()}
    if spent is not None:
        clips[folders[0]].cpu()
        spent["crops"] = spent.get("crops", 0.0) + time.perf_counter() - t1
    return clips
