"""Video container I/O of the v2 (video-native) pipeline.

Port of the JAX package's ``v2/video_io.py`` over the frame I/O seam
(``pipeline/frame_io``): the caller passes the backend, and nothing
chooses it.

  * ``Cv2FrameIO``: the JAX ``VideoIO``'s files, read and written the same
    way: MJPG AVIs, gray channels written with ``isColor=False``, a (T, C,
    H, W) array as C gray videos named ``{c}_<name>`` beside the target
    path, indexed reads decoded in sequence up to the last index asked for,
    "rgb24" reads as the decoded BGR reversed;
  * ``ArrayFrameIO``: each video file holds the lossless (T, H, W) or (T,
    H, W, 3) stack at the same name, so the v2 folders keep the JAX
    layout on a machine without a codec (what the card runs).

A video's frame count and frame size come through the seam too.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from ..pipeline.frame_io import Cv2FrameIO


def channel_path(filename, c: int) -> Path:
    """``<dir>/{c}_<name>``: channel ``c`` of a (T, C, H, W) video."""
    filename = Path(filename)
    return filename.parent / f"{c}_{filename.name}"


class VideoIO:
    """Over ``io``, a ``pipeline/frame_io`` backend; ``Cv2FrameIO()`` (the JAX
    package's cv2 I/O) when none is given."""

    def __init__(self, io=None):
        self.io = Cv2FrameIO() if io is None else io

    def write_video(self, filename, video_array: np.ndarray) -> None:
        """(T, H, W) uint8 gray -> one video file."""
        if video_array.ndim != 3:
            raise ValueError(f"expected (T, H, W), got {video_array.shape}")
        filename = Path(filename)
        filename.parent.mkdir(parents=True, exist_ok=True)
        self.io.write_video(filename, list(video_array), 10.0)

    def write_video_TCHW(self, filename, video_array: np.ndarray) -> None:
        """(T, C, H, W) -> C gray files ``{c}_<name>``."""
        if video_array.ndim != 4:
            raise ValueError(f"expected (T, C, H, W), got {video_array.shape}")
        for c in range(video_array.shape[1]):
            self.write_video(channel_path(filename, c), video_array[:, c])

    def read_video_TCHW(self, filename, channels: int, frames: Sequence[int],
                        format: str = "gray") -> np.ndarray:
        """Indexed clip read -> (T, C, H, W) uint8: "rgb24" reads one colour
        video (RGB, C = 3), "gray" the ``channels`` files ``{c}_<name>``."""
        if format not in ("rgb24", "gray"):
            raise ValueError(f"format {format!r}")
        if format == "rgb24":
            video = self.io.read_frames(filename, frames)  # (T, H, W, 3) BGR
            return np.ascontiguousarray(video[..., ::-1].transpose(0, 3, 1, 2))
        videos = []
        for c in range(channels):
            cpath = channel_path(filename, c)
            if not cpath.is_file():
                raise FileNotFoundError(cpath)
            video = self.io.read_frames(cpath, frames)
            videos.append(video[..., 0] if video.ndim == 4 else video)  # THW
        return np.stack(videos, axis=1)

    def read_video(self, filename, format: str = "rgb24") -> List[np.ndarray]:
        """Every frame: RGB (H, W, 3) or gray (H, W)."""
        if format not in ("rgb24", "gray"):
            raise ValueError(f"format {format!r}")
        if format == "gray":
            return self.io.read_video(filename, gray=True)
        return [np.ascontiguousarray(f[..., ::-1]) for f in self.io.read_video(filename)]

    def frame_count(self, filename) -> int:
        return self.io.frame_count(filename)

    def frame_size(self, filename) -> Tuple[int, int]:
        """(H, W) of the video's frames."""
        return self.io.frame_size(filename)
