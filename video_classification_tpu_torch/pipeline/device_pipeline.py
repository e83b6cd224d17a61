"""On-device preprocessing: raw video -> model-ready part-crop clips.

Port of the JAX package's ``pipeline/device_pipeline.py``. A decoded video
(uint8 frames on the device) plus per-sampled-frame detections become, for
each crop stream, the (S, size, size, 21) uint8 clips the model consumes:
optical flow (kernel K1 on the fused level; K5 and K4 on the per-op level
that ``FlowParams(fuse_level="off")`` or ``n_inner != 1`` selects), 2x padding, the body-aligned 21-channel canvas,
per-part largest-component boxes at heatmap resolution (kernel K2) scaled to
pixels, and the cubic pad-to-square resize. All sampled frames of a clip go
through each step as one batch.

Missing parts (no component, or a box under 15 px) and frames without a
valid detection yield constant-127 frames, the training dataset's
missing-crop convention (chalearn_dataset.py:115-116).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..config.crop_cfg import crop_part_args, crop_resize_dict
from ..data.dataset import MISSING_FILL
from ..ops.components import MIN_PART_SIZE, largest_component_bbox, part_mask
from ..ops.flow import DEFAULT_PARAMS, FlowParams, video_flow_uint8
from ..ops.image import pad2x, pad_to_square_resize, shift2d
from ..utils.profiling import stage


class Detections(NamedTuple):
    """Per-sampled-frame detections (box coords in the 2x-padded frame)."""

    boxes_xyxy: torch.Tensor  # (S, 4) float32; best box per frame
    valid: torch.Tensor       # (S,) bool
    charts: torch.Tensor      # (S, hm, hm) int32, 0..24
    uv: torch.Tensor          # (S, 2, hm, hm) float32 in [0, 1]


def _resize_uv_to_canvas(uv: torch.Tensor, bh: torch.Tensor, bw: torch.Tensor,
                         canvas_hw: Tuple[int, int]):
    """Bilinear upsample of (S, 2, hm, hm) UV to each frame's box size, at the
    canvas origin; 0 outside the box. (The UV half of the JAX package's
    ``_resize_chart_to_canvas``; the canvas never uses the upsampled chart.)

    Row and column sample coordinates are separable, so the resampling is a
    pair of two-tap weight matrices, out = W_y @ uv @ W_x^T, as in the JAX
    package; a clamped second tap adds onto the first tap's entry."""
    hm = uv.shape[-1]
    ch, cw = canvas_hw
    dev = uv.device
    rows = torch.arange(ch, dtype=torch.float32, device=dev)
    cols = torch.arange(cw, dtype=torch.float32, device=dev)
    inside = ((rows[None, :, None] < bh[:, None, None])
              & (cols[None, None, :] < bw[:, None, None]))        # (S, ch, cw)
    src = torch.arange(hm, device=dev)

    def weights(n_out, coords, box):
        f = (coords[None, :] + 0.5) * hm / torch.clamp(box, min=1).float()[:, None]
        g = torch.clamp(f - 0.5, 0.0, hm - 1.0)
        i0 = torch.floor(g).to(torch.int64)
        i1 = torch.clamp(i0 + 1, max=hm - 1)
        wt = (g - i0)[..., None]
        one0 = (src == i0[..., None]).float()
        one1 = (src == i1[..., None]).float()
        return (1.0 - wt) * one0 + wt * one1                        # (S, n, hm)

    wy = weights(ch, rows, bh)
    wx = weights(cw, cols, bw).transpose(1, 2)
    zero = torch.zeros((), device=dev)
    u_full = torch.where(inside, wy @ uv[:, 0] @ wx, zero)
    v_full = torch.where(inside, wy @ uv[:, 1] @ wx, zero)
    return u_full, v_full


def _build_body_canvas(rgb_pad, depth_pad, flow_pad, boxes, uv, canvas_hw):
    """The 21-channel body-aligned canvases of S sampled frames.

    rgb_pad (S, 2H, 2W, 3); depth_pad (S, 2H, 2W, 1); flow_pad
    (S, 5, 2H, 2W, 3); boxes (S, 4) xyxy in padded coords. Returns
    (canvas (S, 2H, 2W, 21) uint8, body_h (S,), body_w (S,))."""
    s = boxes.shape[0]
    x1, y1, x2, y2 = boxes.to(torch.int32).unbind(-1)
    bh = torch.clamp(y2 - y1, min=1)
    bw = torch.clamp(x2 - x1, min=1)
    flows = flow_pad.permute(0, 2, 3, 1, 4).reshape(s, *flow_pad.shape[2:4], -1)
    stacked = torch.cat([rgb_pad, flows, depth_pad], dim=-1)
    body = shift2d(stacked, y1, x1, canvas_hw)                    # (S, ., ., 19)
    u_full, v_full = _resize_uv_to_canvas(uv, bh, bw, canvas_hw)
    u8 = torch.clamp(u_full * 256.0, 0, 255).to(torch.uint8)[..., None]
    v8 = torch.clamp(v_full * 256.0, 0, 255).to(torch.uint8)[..., None]
    canvas = torch.cat([body[..., :3], u8, v8, body[..., 3:]], dim=-1)
    return canvas, bh, bw


def _part_clip_from_canvas(canvas, charts, bh, bw, part_indices, size,
                           part_canvas_hw):
    """One part's crops from S body canvases -> ((S, size, size, 21) float32,
    valid (S,)).

    CC boxes are found at chart (heatmap) resolution and scaled to pixels;
    the >= 15 px rule applies in pixels. The crop lands in a fixed
    ``part_canvas_hw`` window (the original frame size); sizes clip to it."""
    hm = charts.shape[-1]
    mask = part_mask(charts, part_indices)
    bbox, valid = largest_component_bbox(mask, min_size=0)
    hx, hy, hw_, hh = bbox.unbind(-1)
    sx = bw.float() / hm
    sy = bh.float() / hm
    px = (hx.float() * sx).to(torch.int32)
    py = (hy.float() * sy).to(torch.int32)
    pw = torch.clamp((hw_.float() * sx).to(torch.int32), min=1)
    ph = torch.clamp((hh.float() * sy).to(torch.int32), min=1)
    valid = valid & (pw >= MIN_PART_SIZE) & (ph >= MIN_PART_SIZE)
    pw = torch.clamp(pw, max=part_canvas_hw[1])
    ph = torch.clamp(ph, max=part_canvas_hw[0])

    shifted = shift2d(canvas, py, px, part_canvas_hw)
    out = pad_to_square_resize(shifted.float(), size, hw=(ph, pw))
    out = torch.where(valid[:, None, None, None], out,
                      torch.full((), float(MISSING_FILL), device=out.device))
    return out, valid


def preprocess_clip_on_device(
    frames_bgr: torch.Tensor,      # (T_raw, H, W, 3) uint8 raw video
    frames_depth: torch.Tensor,    # (T_raw, H, W, 1) uint8 depth video
    detections: Detections,        # per *sampled* frame
    interval: int = 5,
    parts: Sequence = None,
    flow_params: FlowParams = DEFAULT_PARAMS,
    flow_images: torch.Tensor = None,  # optional precomputed (T_raw, H, W, 3)
    sampled_start: int = 0,
    timer=None,
) -> Dict[str, torch.Tensor]:
    """Returns {crop_folder: (S, size, size, 21) uint8} and
    {'<folder>_valid': (S,) bool} for each part group of ``parts``.

    ``sampled_start`` is the window position of the first sampled frame: 0
    for a video fed from its first frame (the flow companions of sampled
    frame 0 then clamp to the zero self-flow), ``interval`` for a virtual
    window carrying ``interval`` leading context frames
    (pipeline/online.OnlineVideoDataset._virtual_window). ``timer``
    (utils/profiling.StageTimer) records the 'flow' and 'crops' stages."""
    parts = list(parts) if parts is not None else crop_part_args
    t_raw, h, w = frames_bgr.shape[:3]
    dev = frames_bgr.device
    sampled = torch.arange(sampled_start, t_raw, interval, device=dev)
    canvas_hw = (2 * h, 2 * w)

    with stage(timer, "flow"):
        if flow_images is None:
            flow_images = video_flow_uint8(frames_bgr, flow_params)

    with stage(timer, "crops"):
        offsets = torch.arange(-interval + 1, 1, device=dev)
        flow_idx = torch.clamp(sampled[:, None] + offsets[None, :], min=0)  # (S, 5)
        s = sampled.shape[0]
        flow_pad = pad2x(flow_images[flow_idx.reshape(-1)])
        flow_pad = flow_pad.reshape(s, interval, *flow_pad.shape[1:])
        canvas, bh, bw = _build_body_canvas(
            pad2x(frames_bgr[sampled]), pad2x(frames_depth[sampled]),
            flow_pad, detections.boxes_xyxy, detections.uv, canvas_hw)
        outs = {}
        det_ok = detections.valid
        for part_indices, folder in parts:
            size = crop_resize_dict[folder]
            clip, valid = _part_clip_from_canvas(
                canvas, detections.charts, bh, bw, part_indices, size,
                part_canvas_hw=(h, w))
            clip = torch.where(det_ok[:, None, None, None], clip,
                               torch.full((), float(MISSING_FILL), device=dev))
            outs[folder] = torch.clamp(torch.round(clip), 0, 255).to(torch.uint8)
            outs[folder + "_valid"] = valid & det_ok
    return outs
