"""v2 gesture dataset: clip-indexed decode and one union crop box per clip.

Port of the JAX package's ``v2/dataset.py`` (the reference's
``ChalearnGestureDataset``, new_feature_test.py:556-709), reading through
the frame I/O backend the caller passes (``v2/video_io``): each video is a
handful of video files (RGB in 1_Sample, 2-channel flow in 2_Flow_New,
2-channel UV in 5_UV_Video) and a part-box pkl in 6_Box; a clip decodes
only its frame indices, crops the union box of the selected parts over the
whole clip (``x1``, ``y1`` clamped at 0) and resizes it.

  * output: channels-last uint8 (T, S, S, 7), channels [rgb 3, uv 2, flow 2],
    resized on the host with ``ops/image.resize_linear_u8`` on CPU tensors
    (OpenCV's INTER_LINEAR bits, its area rule for an exact 2x downscale of
    7 channels included), so a clip equals the JAX package's;
  * ``seq_len = len(boxes) - 1``, the reference's out-of-bounds guard
    (new_feature_test.py:693-695), which also keeps the flow (T - 1 frames)
    in range;
  * sampling from the ``random.Random`` the caller passes; uniform sampling
    strides by ``clip_len`` (new_feature_test.py:676).
"""

from __future__ import annotations

import pickle
import random as pyrandom
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.image import resize_linear_u8
from ..utils.chapath import ChaPath
from ..utils.labels import get_labels
from . import part_compose
from .video_io import VideoIO

V2_CHANNELS = 7  # rgb 3 + uv 2 + flow 2


class ChalearnGestureDataset:
    def __init__(self, cfg, name_of_set: str, parts: Optional[Sequence[int]] = None,
                 sampling: Optional[str] = None, io=None) -> None:
        if name_of_set not in ("train", "test", "valid"):
            raise ValueError(f"name_of_set {name_of_set!r}")
        self.cfg = cfg
        self.name_of_set = name_of_set
        self.label_list = get_labels(cfg, name_of_set)
        self.parts = list(parts) if parts is not None else part_compose.lHandArmTorso
        self.clip_len = int(cfg.CHALEARN.CLIP_LEN)
        self.input_size = int(cfg.MODEL.INPUT_SIZE)
        if sampling is None:
            sampling = "random" if name_of_set == "train" else "uniform"
        if sampling not in ("random", "uniform"):
            raise ValueError(f"sampling {sampling!r}")
        self.sampling = sampling
        self.vio = VideoIO(io)

    def __len__(self) -> int:
        return len(self.label_list)

    # -- sampling (v2 uniform uses stride == clip_len) ---------------------------

    def _random_sampling(self, seq_len: int, rng: pyrandom.Random) -> List[int]:
        possible = max(0, seq_len - self.clip_len)
        start = rng.randint(0, possible)
        return [i % seq_len for i in range(start, start + self.clip_len)]

    def _uniform_sampling(self, seq_len: int, rng: pyrandom.Random) -> List[List[int]]:
        if seq_len <= self.clip_len:
            return [self._random_sampling(seq_len, rng)]
        return [list(range(t, t + self.clip_len))
                for t in range(0, seq_len - self.clip_len, self.clip_len)]

    # -- feature assembly --------------------------------------------------------

    def features_from_indices(self, clip_indices: List[int], boxes,
                              rgb_path: Path) -> np.ndarray:
        """(T, S, S, 7) uint8 of the frames ``clip_indices``."""
        flow_path = ChaPath(rgb_path).change_base(self.cfg.CHALEARN.FLOW_VIDEO).path
        uv_path = ChaPath(rgb_path).change_base(self.cfg.CHALEARN.UV_VIDEO).path

        boxes_clip = [boxes[i] for i in clip_indices]
        x1, y1, x2, y2 = part_compose.combine_temporal_box_xyxy(boxes_clip, self.parts)
        x1, y1 = max(0, int(x1)), max(0, int(y1))
        x2, y2 = int(x2), int(y2)

        rgb = self.vio.read_video_TCHW(rgb_path, 0, clip_indices, format="rgb24")
        uv = self.vio.read_video_TCHW(uv_path, 2, clip_indices)
        flow = self.vio.read_video_TCHW(flow_path, 2, clip_indices)

        stack = np.concatenate([rgb, uv, flow], axis=1)  # (T, 7, H, W)
        crop = np.ascontiguousarray(stack[:, :, y1:y2, x1:x2].transpose(0, 2, 3, 1))
        size = (self.input_size, self.input_size)
        return resize_linear_u8(torch.from_numpy(crop), size).numpy()

    def _rgb_path(self, m: str) -> Path:
        return Path(self.cfg.CHALEARN.ROOT, self.cfg.CHALEARN.SAMPLE, m)

    def _load_boxes(self, rgb_path: Path):
        box_path = ChaPath(rgb_path).change_base(self.cfg.CHALEARN.BOX).path.with_suffix(".pkl")
        with box_path.open("rb") as f:
            return pickle.load(f)

    # -- Trainer-facing API (as data/dataset.ChalearnVideoDataset) ---------------

    def get_train_clip(self, index: int, rng: pyrandom.Random) -> Dict:
        m, _, label = self.label_list[index]
        rgb_path = self._rgb_path(m)
        boxes = self._load_boxes(rgb_path)
        seq_len = max(1, len(boxes) - 1)
        clip = self._random_sampling(seq_len, rng)
        return {"x": self.features_from_indices(clip, boxes, rgb_path), "label": label - 1}

    def get_eval_clips(self, index: int, rng: pyrandom.Random) -> Dict:
        m, _, label = self.label_list[index]
        rgb_path = self._rgb_path(m)
        boxes = self._load_boxes(rgb_path)
        seq_len = max(1, len(boxes) - 1)
        clips = self._uniform_sampling(seq_len, rng)
        return {"clips": [self.features_from_indices(c, boxes, rgb_path) for c in clips],
                "label": label - 1}

    def num_eval_clips(self, index: int) -> int:
        """Clip count of get_eval_clips without reading any video data."""
        m, _, _ = self.label_list[index]
        seq_len = max(1, len(self._load_boxes(self._rgb_path(m))) - 1)
        if seq_len <= self.clip_len:
            return 1
        return len(range(0, seq_len - self.clip_len, self.clip_len))
