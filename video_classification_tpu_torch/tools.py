"""Inspection tools.

Port of the JAX package's ``tools.py``:

  * ``how_many_classes``, the label statistics of the reference's
    how_many_classes.py;
  * ``render_iuv_boxes``, each frame's first detection box from an IUV pkl
    drawn on the video's frames and written as image files
    (load_iuv_pkl.py:17-49 of the reference draws them with matplotlib),
    through the frame I/O backend the caller passes. The rectangle is
    ``draw_rectangle``, the pixels ``cv2.rectangle`` sets at thickness 2,
    without cv2.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .v2.video_io import VideoIO


def how_many_classes(labels_txt: Path) -> dict:
    """{'min', 'max', 'num_classes', 'num_videos'} of a ChaLearn labels file
    (lines ``M_path K_path label``), printed as the reference prints them."""
    with Path(labels_txt).open("r") as f:
        lines = f.readlines()
    labels = [int(line.split(" ")[2]) for line in lines if line.strip()]
    stats = {
        "min": min(labels),
        "max": max(labels),
        "num_classes": len(set(labels)),
        "num_videos": len(labels),
    }
    print(stats["min"], stats["max"], stats["num_classes"])
    print(f"num of videos: {stats['num_videos']}")
    return stats


def draw_rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int],
                   color: Sequence[int]) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, 2)`` (LINE_8), in place: each of
    the four edges is a band 3 pixels across (the edge's line and one on
    either side) with a 1-pixel cap past each end, clipped to the image."""
    h, w = img.shape[:2]
    x_lo, x_hi = sorted((int(pt1[0]), int(pt2[0])))
    y_lo, y_hi = sorted((int(pt1[1]), int(pt2[1])))

    def fill(r0, r1, c0, c1):
        r0, r1, c0, c1 = max(r0, 0), min(r1, h - 1), max(c0, 0), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            img[r0:r1 + 1, c0:c1 + 1] = color

    for y in (y_lo, y_hi):  # the horizontal edges and their caps
        fill(y - 1, y + 1, x_lo, x_hi)
        fill(y, y, x_lo - 1, x_hi + 1)
    for x in (x_lo, x_hi):  # the vertical edges and their caps
        fill(y_lo, y_hi, x - 1, x + 1)
        fill(y_lo - 1, y_hi + 1, x, x)
    return img


def render_iuv_boxes(iuv_pkl: Path, video_path: Path, out_dir: Path,
                     unpad_offset: Optional[Tuple[int, int]] = None,
                     max_frames: int = 50, io=None) -> int:
    """Draw the first detection box of each frame (red, 2 px) on the video's
    frames and write them as ``<out_dir>/<frame:05d>.jpg`` through ``io``
    (``Cv2FrameIO`` when none is given); returns the frames written.

    ``unpad_offset``: (x_pad, y_pad) to shift padded-frame boxes back onto the
    raw video (defaults to half the frame size, the 2x-pad convention)."""
    vio = VideoIO(io)
    with Path(iuv_pkl).open("rb") as f:
        results = pickle.load(f)
    frames = vio.read_video(video_path, format="rgb24")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if frames and unpad_offset is None:
        h, w = frames[0].shape[:2]
        unpad_offset = (w // 2, h // 2)
    written = 0
    for i, (frame, result) in enumerate(zip(frames, results)):
        if i >= max_frames:
            break
        box = result["pred_boxes_XYXY"]
        if len(box) == 0:
            print("No detection")
            continue
        x1, y1, x2, y2 = np.asarray(box[0], np.float32)
        x1, x2 = x1 - unpad_offset[0], x2 - unpad_offset[0]
        y1, y2 = y1 - unpad_offset[1], y2 - unpad_offset[1]
        img = np.ascontiguousarray(frame[..., ::-1])  # RGB -> BGR
        draw_rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)), (0, 0, 255))
        vio.io.imwrite(out_dir / f"{i:05d}.jpg", img)
        written += 1
    return written
