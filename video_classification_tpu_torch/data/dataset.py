"""ChaLearn crop-stream dataset and its batching (host side).

Port of the JAX package's ``data/dataset.py``: ``ChalearnVideoDataset``
reads one crop stream (``MODEL.R3D_INPUT``) as uint8 clips, ``train_batches``
shuffles and batches an epoch, ``eval_batches`` packs the ragged
clips-per-video stream into fixed batches. Normalization and RandomCrop run
on the device, in the train step (engine/model_manager.py).

A clip is (T, H, W, 21) uint8: 0:3 BGR, 3:5 UV, 5:20 flow (5 frames x 3
channels), 20:21 depth (chalearn_dataset.py:103-113). A missing part crop is
filled with 127 (chalearn_dataset.py:115-116). With
``DATA.SYNTHETIC_NUM_VIDEOS > 0`` the clips are synthetic, in memory, and
equal to the JAX package's. Frames are read with cv2 (imported only then);
the C++ loader of ``DATA.BACKEND native`` is not ported.

The batchers stack what the dataset gives: numpy clips as numpy arrays, and
clips already on a device (the online dataset's) as tensors there.
"""

from __future__ import annotations

import random as pyrandom
from glob import glob
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config.crop_cfg import crop_resize_dict
from ..ops.sampling import num_uniform_clips, random_clip_indices, uniform_clip_indices
from ..utils.labels import SETS, get_labels

NUM_MODALITY_CHANNELS = 21
MISSING_FILL = 127


def _pad_resize_uint8(img: np.ndarray, new_size: int) -> np.ndarray:
    """Reference `_pad_resize_img` (chalearn_dataset.py:60-71) on uint8 HWC."""
    import cv2

    h, w, c = img.shape
    m = max(h, w)
    nx = (m - w) // 2
    ny = (m - h) // 2
    canvas = np.zeros((m, m, c), img.dtype)
    canvas[ny:ny + h, nx:nx + w] = img
    return cv2.resize(canvas, (new_size, new_size), interpolation=cv2.INTER_CUBIC)


class ChalearnVideoDataset:
    """One crop stream (cfg.MODEL.R3D_INPUT) as uint8 clips."""

    def __init__(self, cfg, name_of_set: str, sampling: Optional[str] = None) -> None:
        if name_of_set not in SETS:
            raise ValueError(f"name_of_set must be one of {SETS}, got {name_of_set!r}")
        if str(cfg.DATA.BACKEND) == "native":
            raise NotImplementedError(
                "DATA.BACKEND 'native' (the C++ clip loader) is not ported; "
                "use 'auto' or 'cv2'")
        self.cfg = cfg
        self.name_of_set = name_of_set
        self.clip_len = int(cfg.CHALEARN.CLIP_LEN)
        self.crop_folder = cfg.MODEL.R3D_INPUT
        self.crop_size = crop_resize_dict[self.crop_folder]
        self.synthetic = int(cfg.DATA.SYNTHETIC_NUM_VIDEOS) > 0
        if self.synthetic:
            self.labels = [
                (f"{name_of_set}/m{i}.avi", f"{name_of_set}/k{i}.avi",
                 (i % cfg.CHALEARN.NUM_CLASS) + 1)
                for i in range(int(cfg.DATA.SYNTHETIC_NUM_VIDEOS))]
        else:
            self.labels = get_labels(cfg, name_of_set)
        # Sampling policy (chalearn_dataset.py:52-58).
        self.sampling = sampling or ("random" if name_of_set == "train" else "uniform")

    def __len__(self) -> int:
        return len(self.labels)

    # -- frame loading -----------------------------------------------------------

    def _frame_names(self, nsetx3x5: Path) -> List[str]:
        # The frame list comes from the 2_Images stage
        # (chalearn_dataset.py:166-169); a crop may then be missing (127 fill).
        folder = Path(self.cfg.CHALEARN.ROOT, self.cfg.CHALEARN.IMG, nsetx3x5)
        names = [Path(p).name for p in sorted(glob(str(folder / "*")))]
        return names or ["00000.jpg"]  # no frames at all: an all-missing video

    def _load_frame(self, nsetx3x5img: Path) -> np.ndarray:
        """One frame's 21-channel uint8 stack at the crop's square size."""
        import cv2

        size = self.crop_size
        frame_path = Path(self.cfg.CHALEARN.ROOT, self.crop_folder, nsetx3x5img)
        if not frame_path.exists():
            return np.full((size, size, NUM_MODALITY_CHANNELS), MISSING_FILL, np.uint8)
        name, parent = frame_path.name, frame_path.parent

        def rd(p):  # BGR
            return cv2.imread(str(p))

        def rd_gray(p):
            return cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)[..., None]

        parts = [rd(frame_path), rd_gray(parent / ("U_" + name)),
                 rd_gray(parent / ("V_" + name))]
        parts += [rd(parent / (f"F{i}_" + name)) for i in range(5)]
        parts.append(rd_gray(parent / ("D_" + name)))
        stack = np.concatenate(parts, axis=-1)  # (h, w, 21)
        return _pad_resize_uint8(stack, size)

    def _synthetic_clip(self, index: int, clip_indices: List[int]) -> np.ndarray:
        size = self.crop_size
        label = self.labels[index][2]
        rng = np.random.RandomState((index * 131 + 7) % (2**31))
        base = rng.randint(0, 40, (len(clip_indices), size, size, NUM_MODALITY_CHANNELS))
        return (base + 40 + (label - 1) * 3).astype(np.uint8)

    def _seq_len(self, index: int) -> Tuple[int, List[str], Path]:
        m, _, _ = self.labels[index]
        nsetx3x5 = Path(m).parent / Path(m).stem  # train/001/M_00068
        if self.synthetic:
            return int(self.cfg.DATA.SYNTHETIC_SEQ_LEN), [], nsetx3x5
        names = self._frame_names(nsetx3x5)
        return len(names), names, nsetx3x5

    def _collect(self, index: int, clip_indices: List[int], names: List[str],
                 nsetx3x5: Path) -> np.ndarray:
        if self.synthetic:
            return self._synthetic_clip(index, clip_indices)
        return np.stack([self._load_frame(nsetx3x5 / names[i]) for i in clip_indices])

    # -- public API -------------------------------------------------------------

    def get_train_clip(self, index: int, rng: pyrandom.Random) -> Dict:
        seq_len, names, nsetx3x5 = self._seq_len(index)
        clip_idx = random_clip_indices(max(seq_len, 1), self.clip_len, rng)
        return {"x": self._collect(index, clip_idx, names, nsetx3x5),
                "label": self.labels[index][2] - 1}  # 0-based labels

    def get_eval_clips(self, index: int, rng: pyrandom.Random) -> Dict:
        seq_len, names, nsetx3x5 = self._seq_len(index)
        clips = uniform_clip_indices(max(seq_len, 1), self.clip_len, rng)
        return {"clips": [self._collect(index, ci, names, nsetx3x5) for ci in clips],
                "label": self.labels[index][2] - 1}

    def num_eval_clips(self, index: int) -> int:
        """Clip count of get_eval_clips, without loading any frame."""
        seq_len, _, _ = self._seq_len(index)
        return num_uniform_clips(max(seq_len, 1), self.clip_len)


# -- batching -------------------------------------------------------------------------


def stack_clips(clips):
    """Stack numpy clips as a numpy array, tensors as a tensor on their device."""
    if isinstance(clips[0], torch.Tensor):
        return torch.stack(clips)
    return np.stack(clips)


def train_batches(dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                  drop_last: bool = True) -> Iterator[Dict]:
    """One epoch of uint8 train batches {'x', 'label'} (shuffle and
    drop_last, train.py:164); one ``random.Random(seed)`` shuffles the epoch
    and samples every clip, as in the JAX package."""
    rng = pyrandom.Random(seed)
    order = list(range(len(dataset)))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        samples = [dataset.get_train_clip(i, rng) for i in chunk]
        yield {"x": stack_clips([s["x"] for s in samples]),
               "label": np.asarray([s["label"] for s in samples], np.int32)}


def eval_batches(dataset, batch_size: int,
                 seed: int = 0) -> Tuple[Iterator[Dict], List[int]]:
    """Pack the ragged clips-per-video stream into batches of ``batch_size``
    (train.py:297-335). The last partial batch is padded with copies of its
    first clip and carries a ``valid`` mask. Returns (generator of {'x',
    'label', 'valid'}, samples_per_video), the latter computed up front from
    the clip counts alone; each video draws its clips from its own
    ``random.Random(seed * 1_000_003 + index)``."""
    samples_per_video = [dataset.num_eval_clips(i) for i in range(len(dataset))]

    def gen():
        pending_x: list = []
        pending_y: List[int] = []
        for index in range(len(dataset)):
            item = dataset.get_eval_clips(index, pyrandom.Random(seed * 1_000_003 + index))
            if len(item["clips"]) != samples_per_video[index]:
                raise AssertionError(
                    f"video {index}: {len(item['clips'])} clips, "
                    f"{samples_per_video[index]} promised")
            pending_x.extend(item["clips"])
            pending_y.extend([item["label"]] * len(item["clips"]))
            while len(pending_x) >= batch_size:
                yield {"x": stack_clips(pending_x[:batch_size]),
                       "label": np.asarray(pending_y[:batch_size], np.int32),
                       "valid": np.ones(batch_size, bool)}
                pending_x = pending_x[batch_size:]
                pending_y = pending_y[batch_size:]
        if pending_x:
            n = len(pending_x)
            pad = batch_size - n
            valid = np.zeros(batch_size, bool)
            valid[:n] = True
            yield {"x": stack_clips(pending_x + [pending_x[0]] * pad),
                   "label": np.asarray(pending_y + [0] * pad, np.int32),
                   "valid": valid}

    return gen(), samples_per_video
