"""Detection primitives on batched tensors: ROIAlign, box decoding, IoU, NMS.

Port of the JAX package's ``detect/ops.py``, batched over frames: feature
maps are (B, C, H, W), boxes (B, N, 4) xyxy in image pixels, and pooled ROIs
come out as (B, N, C, S, S), the layout of the port's channels-first heads.
ROIAlign keeps the JAX package's semantics, not torchvision's or
detectron2's CUDA ROIAlign: the aligned=True half-pixel shift, sample
coordinates clamped to [0, H-1] x [0, W-1], the base corner clamped to
(H-2, W-2), the bilinear blend in the feature dtype and the mean of a
``sampling_ratio`` x ``sampling_ratio`` grid per bin. ``nms`` is kernel K3
(``detect/nms.py``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .nms import nms  # noqa: F401  (re-exported)


def _sample_grid(flat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                 lh: torch.Tensor, lw: torch.Tensor, loff: torch.Tensor
                 ) -> torch.Tensor:
    """Bilinear samples of a flattened (B, C, L) map at per-box grids.

    ys, xs: (B, N, s) sample coordinates on each box's map, whose height,
    width and offset into L are lh, lw, loff (B, N). Returns
    (B, C, N, s, s). Coordinates clamp to the map; the base corner clamps to
    (h-2, w-2), where the fractional weight 1 selects the last row/col."""
    b, c, _ = flat.shape
    n, s = ys.shape[1:]
    ys = torch.minimum(torch.clamp(ys, min=0.0), (lh - 1).float()[..., None])
    xs = torch.minimum(torch.clamp(xs, min=0.0), (lw - 1).float()[..., None])
    y0 = torch.minimum(torch.floor(ys).long(), torch.clamp(lh - 2, min=0)[..., None])
    x0 = torch.minimum(torch.floor(xs).long(), torch.clamp(lw - 2, min=0)[..., None])
    wy = (ys - y0)[:, None, :, :, None].to(flat.dtype)   # (B, 1, N, s, 1)
    wx = (xs - x0)[:, None, :, None, :].to(flat.dtype)   # (B, 1, N, 1, s)
    idx = (loff[..., None, None] + y0[..., :, None] * lw[..., None, None]
           + x0[..., None, :])                           # (B, N, s, s)
    row = lw[..., None, None].expand_as(idx)

    def take(i):
        return torch.gather(flat, 2, i.reshape(b, 1, -1).expand(b, c, -1)
                            ).reshape(b, c, n, s, s)

    v00, v01 = take(idx), take(idx + 1)
    v10, v11 = take(idx + row), take(idx + row + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


def _bin_mean(samples: torch.Tensor, output_size: int, ratio: int) -> torch.Tensor:
    """(B, C, N, out*r, out*r) samples -> (B, N, C, out, out) bin means."""
    b, c, n = samples.shape[:3]
    return samples.reshape(b, c, n, output_size, ratio, output_size, ratio
                           ).mean(dim=(4, 6)).permute(0, 2, 1, 3, 4)


def _grid(output_size: int, ratio: int, device) -> torch.Tensor:
    """(out*r,) sample offsets in bins: i + (k + 0.5) / r."""
    i = torch.arange(output_size, dtype=torch.float32, device=device)
    k = torch.arange(ratio, dtype=torch.float32, device=device)
    return (i[:, None] + (k[None, :] + 0.5) / ratio).reshape(-1)


def roi_align(feat: torch.Tensor, boxes_xyxy: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign (aligned=True) of one level: feat (B, C, H, W), boxes
    (B, N, 4) in image coords -> (B, N, C, output_size, output_size)."""
    b, c, h, w = feat.shape
    boxes = boxes_xyxy.float() * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = torch.clamp(x2 - x1, min=1e-6) / output_size
    bin_h = torch.clamp(y2 - y1, min=1e-6) / output_size
    grid = _grid(output_size, sampling_ratio, feat.device)
    ys = (y1[..., None] + grid * bin_h[..., None]) - 0.5
    xs = (x1[..., None] + grid * bin_w[..., None]) - 0.5

    def per_box(v):
        return torch.full_like(x1, v, dtype=torch.long)

    samples = _sample_grid(feat.reshape(b, c, h * w), ys, xs, per_box(h),
                           per_box(w), per_box(0))
    return _bin_mean(samples, output_size, sampling_ratio)


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes_xyxy: torch.Tensor,
                         output_size: int, strides=(4, 8, 16, 32),
                         sampling_ratio: int = 2, canonical_level: int = 2
                         ) -> torch.Tensor:
    """FPN ROIAlign: each box pools only its assigned level,
    floor(canonical_level + log2(sqrt(wh) / 224 + 1e-8)) clipped to the
    levels, with w and h floored at 1 (detectron2 assign_boxes_to_levels).

    feats: (B, C, H_l, W_l) maps (P2..P5); boxes (B, N, 4) -> (B, N, C,
    output_size, output_size). The levels are flattened into one (B, C, L)
    map so the per-box level is index arithmetic."""
    b, c = feats[0].shape[:2]
    dev = feats[0].device
    flat = torch.cat([f.reshape(b, c, -1) for f in feats], dim=2)
    sizes = [(f.shape[2], f.shape[3]) for f in feats]
    hs = torch.tensor([h for h, _ in sizes], device=dev)
    ws = torch.tensor([w for _, w in sizes], device=dev)
    offs = torch.tensor([0] + [h * w for h, w in sizes], device=dev).cumsum(0)[:-1]
    inv_strides = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                               device=dev)

    boxes = boxes_xyxy.float()
    bw = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0)
    bh = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    k = torch.floor(canonical_level + torch.log2(torch.sqrt(bw * bh) / 224.0 + 1e-8))
    level = torch.clamp(k, 0, len(feats) - 1).long()            # (B, N)
    scale = inv_strides[level]
    grid = _grid(output_size, sampling_ratio, dev)
    x1 = boxes[..., 0] * scale
    y1 = boxes[..., 1] * scale
    bin_w = torch.clamp((boxes[..., 2] - boxes[..., 0]) * scale, min=1e-6) / output_size
    bin_h = torch.clamp((boxes[..., 3] - boxes[..., 1]) * scale, min=1e-6) / output_size
    ys = y1[..., None] + grid * bin_h[..., None] - 0.5
    xs = x1[..., None] + grid * bin_w[..., None] - 0.5
    samples = _sample_grid(flat, ys, xs, hs[level], ws[level], offs[level])
    return _bin_mean(samples, output_size, sampling_ratio)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of each row, descending, lower indices first
    among equal values: jax.lax.top_k's order, which torch.topk does not
    promise. (The zero padding around a frame makes many equal
    objectness scores, and the NMS that follows depends on their order.)"""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Clamp (..., 4) xyxy boxes to [0, w] x [0, h]."""
    h, w = hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.clamp(x1, 0, w), torch.clamp(y1, 0, h),
                        torch.clamp(x2, 0, w), torch.clamp(y2, 0, h)], dim=-1)


def apply_deltas(anchors: torch.Tensor, deltas: torch.Tensor,
                 clip: float = 4.135, weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """R-CNN box decoding of (..., 4) (dx, dy, dw, dh) deltas on xyxy anchors.

    ``weights`` are detectron2's Box2BoxTransform normalisers, (1, 1, 1, 1)
    for the RPN and (10, 10, 5, 5) for the box head; ``clip`` is its
    scale_clamp log(1000/16)."""
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    wx, wy, ww, wh = weights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw, dh = deltas[..., 2] / ww, deltas[..., 3] / wh
    cx = ax + dx * aw
    cy = ay + dy * ah
    w = aw * torch.exp(torch.clamp(dw, -clip, clip))
    h = ah * torch.exp(torch.clamp(dh, -clip, clip))
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
