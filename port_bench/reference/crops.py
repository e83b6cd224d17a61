"""Plain PyTorch body-part crops of a clip window (reference copy).

What the serving path makes of a window's raw frames once their flow is
known (the ChaLearn reference's chalearn_image_to_padded.py,
chalearn_iuv_to_crop.py and chalearn_dataset.py, as the JAX package runs them
on the device): each sampled frame and its five flow companions padded 2x,
the 21-channel canvas aligned on the detected body box (BGR, U, V from the
chart's UV resized to the box, 15 flow channels, depth), and per part group
the largest 8-connected component of the part's chart mask, scaled to
pixels, a box under 15 px counted as missing, centred in a square and
resized by OpenCV's bicubic kernel (A = -0.75) to the stream's size;
missing crops are 127.

``synthetic_detections`` is the deterministic detector the serving path
uses with ``DATA.ONLINE_DETECTOR synthetic``: a centred body box and banded
part charts at 56 x 56. Every matrix product here is float32 (TF32 off).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

MISSING_FILL = 127
MIN_PART_SIZE = 15
HEATMAP = 56

# Chart indices of the DensePose "I" map and the square size of each served
# crop stream (crop_cfg.py).
_LHAND, _RHAND = [4], [3]
_LARM, _RARM = [21, 19, 17, 15], [20, 22, 16, 18]
_TORSO, _HEAD = [1, 2], [23, 24]
PARTS = {
    "CropHTAH": (_LHAND + _LARM + _TORSO + _HEAD + _RARM + _RHAND, 192),
    "CropLHand": (_LHAND, 64),
    "CropRHand": (_RHAND, 64),
    "CropLHandArm": (_LHAND + _LARM, 128),
    "CropRHandArm": (_RHAND + _RARM, 128),
}


def synthetic_detections(s: int, h: int, w: int, device):
    """(boxes (S, 4) xyxy in the 2x-padded frame, valid (S,), charts (S, 56,
    56) int64, uv (S, 2, 56, 56)) of ``s`` sampled h x w frames."""
    hm = HEATMAP
    rows = np.broadcast_to(np.arange(hm)[:, None], (hm, hm))
    cols = np.broadcast_to(np.arange(hm)[None, :], (hm, hm))
    c = np.zeros((hm, hm), np.int64)
    c[rows < hm // 5] = 23
    band = (rows >= hm // 5) & (rows < 2 * hm // 5)
    c[band] = 1
    c[band & (cols >= hm // 2)] = 2
    arm = (rows >= 2 * hm // 5) & (rows < 3 * hm // 5)
    c[arm & (cols < hm // 2)] = 7
    c[arm & (cols >= hm // 2)] = 6
    hand = rows >= 3 * hm // 5
    c[hand & (cols < hm // 2)] = 4
    c[hand & (cols >= hm // 2)] = 3
    box = np.asarray([w * 0.6, h * 0.55, w * 1.4, h * 1.45], np.float32)
    uu = np.linspace(0.0, 1.0, hm, dtype=np.float32)
    uv = np.stack([np.tile(uu, (hm, 1)), np.tile(uu[:, None], (1, hm))])
    return (torch.from_numpy(np.tile(box, (s, 1))).to(device),
            torch.ones((s,), dtype=torch.bool, device=device),
            torch.from_numpy(c).to(device).expand(s, hm, hm),
            torch.from_numpy(uv).to(device).expand(s, 2, hm, hm))


def pad2x(img: torch.Tensor) -> torch.Tensor:
    *lead, h, w, c = img.shape
    out = img.new_zeros((*lead, 2 * h, 2 * w, c))
    out[..., h // 2:h // 2 + h, w // 2:w // 2 + w, :] = img
    return out


def shift2d(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, out_hw) -> torch.Tensor:
    """out[s, y, x] = img[s, y + dy[s], x + dx[s]], zero outside."""
    s, h, w = img.shape[:3]
    oh, ow = out_hw
    dev = img.device
    out = img.new_zeros((s, oh, ow) + tuple(img.shape[3:]))
    for i in range(s):
        y0, x0 = int(dy[i]), int(dx[i])
        ys, ye = max(0, -y0), min(oh, h - y0)
        xs, xe = max(0, -x0), min(ow, w - x0)
        if ye > ys and xe > xs:
            out[i, ys:ye, xs:xe] = img[i, ys + y0:ye + y0, xs + x0:xe + x0]
    return out.to(dev)


def _uv_to_canvas(uv, bh, bw, canvas_hw):
    """Bilinear upsample of (S, 2, hm, hm) UV to each box's size at the
    canvas origin (half-pixel centres, clamped taps), 0 outside the box."""
    hm = uv.shape[-1]
    ch, cw = canvas_hw
    dev = uv.device

    def weights(n_out, box):
        f = (torch.arange(n_out, device=dev).float()[None, :] + 0.5) * hm \
            / torch.clamp(box, min=1).float()[:, None]
        g = torch.clamp(f - 0.5, 0.0, hm - 1.0)
        i0 = torch.floor(g).long()
        i1 = torch.clamp(i0 + 1, max=hm - 1)
        t = g - i0.float()
        wmat = torch.zeros((box.shape[0], n_out, hm), device=dev)
        wmat.scatter_add_(2, i0[..., None], (1.0 - t)[..., None])
        wmat.scatter_add_(2, i1[..., None], t[..., None])
        return wmat

    wy, wx = weights(ch, bh), weights(cw, bw).transpose(1, 2)
    inside = ((torch.arange(ch, device=dev)[None, :, None] < bh[:, None, None])
              & (torch.arange(cw, device=dev)[None, None, :] < bw[:, None, None]))
    zero = torch.zeros((), device=dev)
    return (torch.where(inside, wy @ uv[:, 0] @ wx, zero),
            torch.where(inside, wy @ uv[:, 1] @ wx, zero))


def largest_component_box(mask: torch.Tensor) -> Tuple[int, int, int, int, bool]:
    """(x, y, w, h, found) of the largest-area bounding box among the
    8-connected components of one (H, W) bool mask; a tie goes to the
    component whose first pixel in row-major order comes first."""
    h, w = mask.shape
    m = mask.cpu().numpy()
    label = np.full((h, w), -1, np.int64)
    best = (0, 0, 0, 0, False)
    best_area = 0
    for start in np.flatnonzero(m.ravel()):
        sy, sx = divmod(int(start), w)
        if label[sy, sx] >= 0:
            continue
        stack = [(sy, sx)]
        label[sy, sx] = start
        y0 = y1 = sy
        x0 = x1 = sx
        while stack:
            y, x = stack.pop()
            y0, y1, x0, x1 = min(y0, y), max(y1, y), min(x0, x), max(x1, x)
            for ny in (y - 1, y, y + 1):
                for nx in (x - 1, x, x + 1):
                    if 0 <= ny < h and 0 <= nx < w and m[ny, nx] and label[ny, nx] < 0:
                        label[ny, nx] = start
                        stack.append((ny, nx))
        area = (x1 - x0 + 1) * (y1 - y0 + 1)
        if area > best_area:
            best_area = area
            best = (x0, y0, x1 - x0 + 1, y1 - y0 + 1, True)
    return best


def cubic_kernel(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    ax = torch.abs(x)
    inner = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    outer = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, inner, torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def _cubic_matrix(n_in: int, n_out: int, canvas: int, device) -> torch.Tensor:
    """(n_out, canvas) weights of OpenCV's INTER_CUBIC from the top-left
    ``n_in`` samples: src = (dst + 0.5) * n_in / n_out - 0.5, four taps
    clamped to [0, n_in - 1]."""
    src = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * (n_in / n_out) - 0.5
    base = torch.floor(src)
    taps = torch.arange(-1, 3, dtype=torch.float32, device=device)
    idx = torch.clamp(base[:, None] + taps, 0, n_in - 1).long()
    wts = cubic_kernel((src - base)[:, None] - taps)
    mat = torch.zeros((n_out, canvas), device=device)
    mat.scatter_add_(1, idx, wts)
    return mat


def square_resize(img: torch.Tensor, h: int, w: int, size: int) -> torch.Tensor:
    """(H, W, C) float32 whose content is its top-left h x w: centred in a
    max(h, w) square of zeros, bicubic-resized to (size, size, C)."""
    m = max(h, w)
    cm = max(img.shape[0], img.shape[1])
    sq = img.new_zeros((cm, cm, img.shape[2]))
    ny, nx = (m - h) // 2, (m - w) // 2
    sq[ny:ny + h, nx:nx + w] = img[:h, :w]
    mat = _cubic_matrix(m, size, cm, img.device)
    return torch.einsum("ow,hwc->hoc", mat, torch.einsum("oh,hwc->owc", mat, sq))


def window_crops(frames: torch.Tensor, depth: torch.Tensor, flow_images: torch.Tensor,
                 folders: Sequence[str], interval: int = 5) -> Dict[str, torch.Tensor]:
    """{folder: (S, size, size, 21) uint8} of one window: ``frames`` (N, H, W,
    3) and ``depth`` (N, H, W, 1) uint8 are the window's raw frames (sampled
    frame k at position (k + 1) * interval), ``flow_images`` (N, H, W, 3)
    their flow images (position j: frames j - 1 -> j)."""
    n, h, w = frames.shape[:3]
    dev = frames.device
    sampled = torch.arange(interval, n, interval, device=dev)
    s = sampled.shape[0]
    boxes, valid, charts, uv = synthetic_detections(s, h, w, dev)
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
            sx, sy = float(bw[i]) / HEATMAP, float(bh[i]) / HEATMAP
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
