"""Frame I/O of the offline chain: the one seam through which every stage
(``pipeline/stages.py``) and the fixture (``data/fixture.py``) read and
write images and videos.

Two implementations, and no automatic choice between them; the caller
passes one:

  * ``Cv2FrameIO`` - JPEG images and AVI videos through OpenCV, what the
    JAX package's stages do (its ``pipeline/stages.py`` calls ``cv2``
    directly). The default of the stages and of the CLI. ``cv2`` is imported
    when one is constructed; without it the constructor raises an
    ``ImportError`` that names ``ArrayFrameIO``.
  * ``ArrayFrameIO`` - lossless ``.npy`` payloads written at the reference's
    paths and names (``00005.jpg``, ``M_00001.avi``), so the stage-folder
    layout and every glob are the reference's. No codec is needed, so it
    runs where OpenCV or a codec is not installed, and a chain run
    through it on two devices can be compared exactly. Times of the
    I/O-bound stages measured through it exclude JPEG and AVI coding.

Images are BGR ``(H, W, 3)`` or gray ``(H, W)`` uint8 arrays; videos are
lists of BGR frames, or of gray frames (the v2 pipeline's one-channel
videos, ``v2/video_io.py``). Besides whole-video reads, a backend reads the
frames at given indices (``read_frames``), a video's frame count and its
frame size, which is what the v2 pipeline asks of a video file.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np


class Cv2FrameIO:
    """JPEG and AVI through OpenCV (``cv2``)."""

    def __init__(self):
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                "Cv2FrameIO needs OpenCV (the cv2 module), which is not installed; "
                "pass io=ArrayFrameIO() to read and write lossless .npy frames "
                "without a codec") from e
        self._cv2 = cv2

    def read_video(self, path, gray: bool = False) -> List[np.ndarray]:
        """Every frame, BGR, or converted to gray (COLOR_BGR2GRAY)."""
        cap = self._cv2.VideoCapture(str(path))
        frames = []
        try:
            while cap.isOpened():
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)
                              if gray else frame)
        finally:
            cap.release()
        return frames

    def read_frames(self, path, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), H, W, 3) BGR frames at ``indices``, decoded in
        sequence up to the last one asked for (OpenCV has no random access)."""
        cap = self._cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise FileNotFoundError(f"cv2 could not open {path}")
        need = sorted(set(int(i) for i in indices))
        got = {}
        idx = 0
        try:
            ok, frame = cap.read()
            while ok and need:
                if idx == need[0]:
                    got[idx] = frame
                    need.pop(0)
                idx += 1
                if need:
                    ok, frame = cap.read()
        finally:
            cap.release()
        if need:
            raise IndexError(f"frames {need} out of range in {path}")
        return np.stack([got[int(i)] for i in indices])

    def _property(self, path, prop) -> int:
        cap = self._cv2.VideoCapture(str(path))
        try:
            return int(cap.get(prop))
        finally:
            cap.release()

    def frame_count(self, path) -> int:
        """The container's frame count (CAP_PROP_FRAME_COUNT)."""
        return self._property(path, self._cv2.CAP_PROP_FRAME_COUNT)

    def frame_size(self, path):
        """(H, W) of a video's frames, from the container."""
        return (self._property(path, self._cv2.CAP_PROP_FRAME_HEIGHT),
                self._property(path, self._cv2.CAP_PROP_FRAME_WIDTH))

    def imread(self, path, gray: bool = False) -> np.ndarray:
        flag = self._cv2.IMREAD_GRAYSCALE if gray else self._cv2.IMREAD_COLOR
        img = self._cv2.imread(str(path), flag)
        if img is None:
            raise FileNotFoundError(f"cv2 could not read {path}")
        return img

    def imwrite(self, path, img: np.ndarray) -> None:
        # cv2.imwrite reports failure only by its return value
        # (chalearn_video_to_images.py:31).
        if not self._cv2.imwrite(str(path), img):
            raise OSError(f"cv2 could not write {path}")

    def write_video(self, path, frames: Sequence[np.ndarray], fps: float = 10.0) -> None:
        """An MJPG AVI; gray (H, W) frames are written with ``isColor=False``,
        as the JAX package's v2 ``VideoIO`` writes them."""
        h, w = frames[0].shape[:2]
        writer = self._cv2.VideoWriter(str(path), self._cv2.VideoWriter_fourcc(*"MJPG"),
                                       fps, (w, h), frames[0].ndim == 3)
        if not writer.isOpened():
            raise OSError(f"cv2 could not open {path} for writing")
        try:
            for frame in frames:
                writer.write(np.ascontiguousarray(frame))
        finally:
            writer.release()


class ArrayFrameIO:
    """Lossless ``.npy`` payloads at the reference's file names.

    An "image" file holds one array, a "video" file the (T, H, W, 3) or,
    gray, (T, H, W) stack of its frames. Reading a gray payload in colour
    repeats it over three channels, as ``cv2.imread`` does with a gray JPEG;
    reading a colour payload in gray raises (OpenCV's BGR-to-gray rounding
    is not reproduced, and no stage asks for it)."""

    def read_video(self, path, gray: bool = False) -> List[np.ndarray]:
        """Every frame; in gray only from a gray stack (a colour one raises,
        as ``imread`` does)."""
        stack = np.load(path)
        if gray and stack.ndim != 3:
            raise ValueError(f"{path} holds a colour video; read it in colour")
        return list(stack)

    def read_frames(self, path, indices: Sequence[int]) -> np.ndarray:
        """The frames at ``indices``: (n, H, W, 3), or (n, H, W) of a gray
        video."""
        stack = np.load(path, mmap_mode="r")
        idx = np.asarray(indices, np.int64)
        bad = sorted(set(int(i) for i in idx if not 0 <= i < stack.shape[0]))
        if bad:
            raise IndexError(f"frames {bad} out of range in {path}")
        return np.ascontiguousarray(stack[idx])

    def frame_count(self, path) -> int:
        return int(np.load(path, mmap_mode="r").shape[0])

    def frame_size(self, path):
        return tuple(int(n) for n in np.load(path, mmap_mode="r").shape[1:3])

    def imread(self, path, gray: bool = False) -> np.ndarray:
        img = np.load(path)
        if gray:
            if img.ndim != 2:
                raise ValueError(f"{path} holds a colour image; read it in colour")
            return img
        return np.repeat(img[..., None], 3, axis=2) if img.ndim == 2 else img

    def imwrite(self, path, img: np.ndarray) -> None:
        # A file object: np.save would append ".npy" to a path.
        with Path(path).open("wb") as f:
            np.save(f, np.ascontiguousarray(img))

    def write_video(self, path, frames: Sequence[np.ndarray], fps: float = 10.0) -> None:
        self.imwrite(path, np.stack(frames))
