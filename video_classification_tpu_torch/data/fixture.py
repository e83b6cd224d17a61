"""Synthetic mini-ChaLearn fixture.

Port of the JAX package's ``data/fixture.py``: a tiny deterministic on-disk
dataset in the stage-folder layout, written through a frame I/O
(``pipeline/frame_io``; ``Cv2FrameIO`` by default, ``ArrayFrameIO`` where no
codec is wanted). The numpy ``RandomState`` draws come in the JAX package's
order, so a seed gives its frames.

    generate_raw_fixture: <ROOT>/0_Iso/IsoGD_labels/<set>.txt and the M_/K_
        .avi pairs, the input of the offline chain (chalearn_sample_data.py
        reads this layout);
    generate_fixture: <ROOT>/1_Sample/<set>.txt, 2_Images frame listings and
        <CropX>/<set>/<xxx>/<M_xxxxx>/<fffff>.jpg crops with their U, V, D
        and F0..F4 companions (what chalearn_iuv_to_crop.py writes and
        dataset/chalearn_dataset.py:103-113 reads).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np

from ..pipeline.frame_io import Cv2FrameIO
from ..utils.labels import write_labels


def generate_raw_fixture(
    cfg,
    num_videos_per_set: int = 2,
    num_classes: int = 2,
    num_frames: int = 10,
    hw=(48, 64),
    sets: Sequence[str] = ("train",),
    seed: int = 0,
    class_sep: int = 50,
    io=None,
) -> None:
    """Raw M_/K_ video pairs of a moving bright square on noise (non-trivial
    flow), with a per-class brightness offset ((label-1) * class_sep) so the
    labels are separable from the pixels, and the label files."""
    io = Cv2FrameIO() if io is None else io
    rng = np.random.RandomState(seed)
    iso = Path(cfg.CHALEARN.ROOT) / cfg.CHALEARN.ISO
    h, w = hw
    for name_of_set in sets:
        lines = []
        for vi in range(num_videos_per_set):
            label = (vi % num_classes) + 1
            xxx = f"{label:03d}"
            vid = f"{vi + 1:05d}"
            m_rel = f"{name_of_set}/{xxx}/M_{vid}.avi"
            k_rel = f"{name_of_set}/{xxx}/K_{vid}.avi"
            lines.append(f"{m_rel} {k_rel} {label}\n")
            for rel in (m_rel, k_rel):
                path = iso / name_of_set / rel
                path.parent.mkdir(parents=True, exist_ok=True)
                frames = []
                for t in range(num_frames):
                    offset = (label - 1) * class_sep
                    frame = (rng.randint(0, 60, (h, w, 3)) + offset).clip(
                        0, 255).astype(np.uint8)
                    x0, y0 = 4 + 2 * t, 4 + t  # the moving square
                    frame[y0:y0 + 12, x0:x0 + 12] = 220
                    frames.append(frame)
                io.write_video(path, frames, 10.0)
        labels_txt = iso / "IsoGD_labels" / f"{name_of_set}.txt"
        labels_txt.parent.mkdir(parents=True, exist_ok=True)
        labels_txt.write_text("".join(lines))


def generate_fixture(
    cfg,
    num_videos_per_set: int = 4,
    num_classes: int = 3,
    frames_per_video: int = 6,
    crops: Sequence[str] = ("CropLHand",),
    sets: Sequence[str] = ("train", "test"),
    base_size: int = 48,
    seed: int = 0,
    io=None,
) -> None:
    """The crop-stage fixture under cfg.CHALEARN.ROOT."""
    io = Cv2FrameIO() if io is None else io
    rng = np.random.RandomState(seed)
    root = Path(cfg.CHALEARN.ROOT)
    interval = cfg.CHALEARN.IMG_SAMPLE_INTERVAL

    for name_of_set in sets:
        labels: List = []
        for vi in range(num_videos_per_set):
            label = (vi % num_classes) + 1  # labels are 1-based
            xxx = f"{label:03d}"
            vid = f"{vi + 1:05d}"
            labels.append(
                (f"{name_of_set}/{xxx}/M_{vid}.avi", f"{name_of_set}/{xxx}/K_{vid}.avi", label))
            # The 2_Images stage lists the frames (chalearn_dataset.py:166-169).
            img_folder = root / cfg.CHALEARN.IMG / name_of_set / xxx / f"M_{vid}"
            img_folder.mkdir(parents=True, exist_ok=True)
            for fi in range(frames_per_video):
                io.imwrite(img_folder / f"{fi * interval:05d}.jpg",
                           rng.randint(0, 255, (24, 32, 3), dtype=np.uint8))
            for crop in crops:
                folder = root / crop / name_of_set / xxx / f"M_{vid}"
                folder.mkdir(parents=True, exist_ok=True)
                for fi in range(frames_per_video):
                    # Every interval-th raw frame (chalearn_video_to_images.py:22-28).
                    name = f"{fi * interval:05d}.jpg"
                    h = base_size + int(rng.randint(-8, 9))
                    w = base_size + int(rng.randint(-8, 9))
                    # A class-dependent mean, so that models can fit the data;
                    # the sum saturates at 255, as cv2.add does.
                    noise = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
                    bgr = np.minimum(noise.astype(np.int32) + 40 + 60 * (label - 1), 255)
                    io.imwrite(folder / name, bgr.astype(np.uint8))
                    for prefix in ("U_", "V_", "D_"):
                        io.imwrite(folder / (prefix + name),
                                   rng.randint(0, 255, (h, w), dtype=np.uint8))
                    for i in range(5):
                        io.imwrite(folder / (f"F{i}_" + name),
                                   rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
        write_labels(cfg, name_of_set, labels)
