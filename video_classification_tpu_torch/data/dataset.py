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
equal to the JAX package's. Frames are decoded on the host, as in the JAX
package: ``DATA.BACKEND`` 'auto' takes the native C++ loader
(native/loader.py) when it builds and cv2 otherwise, 'native' raises when
the loader cannot be built, 'cv2' reads with cv2 (imported only then).

The batchers stack what the dataset gives: numpy clips as numpy arrays, and
clips already on a device (the online dataset's) as tensors there.
"""

from __future__ import annotations

import random as pyrandom
from glob import glob
from pathlib import Path
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

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
        # The host decoder: the C++ worker pool for 'auto' and 'native' when
        # it builds, else cv2 ('native' raises instead).
        self._native = None
        backend = str(cfg.DATA.BACKEND)
        if not self.synthetic and backend in ("auto", "native"):
            from ..native import loader

            if loader.native_available():
                self._native = loader.NativeClipLoader(num_threads=min(int(cfg.NUM_CPU), 8))
            elif backend == "native":
                raise RuntimeError("DATA.BACKEND 'native' but the native loader is "
                                   f"unavailable: {loader.build_error()}")

    @property
    def decoder(self) -> str:
        """'synthetic', 'native' or 'cv2': what makes this dataset's clips."""
        return "synthetic" if self.synthetic else "native" if self._native else "cv2"

    def __len__(self) -> int:
        return len(self.labels)

    def sample_shape(self) -> Tuple[int, int, int, int]:
        """Per-clip array shape (T, S, S, 21), without decoding."""
        return (self.clip_len, self.crop_size, self.crop_size, NUM_MODALITY_CHANNELS)

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
        if self._native is not None:
            from ..native.loader import frame_paths_for

            paths: List[str] = []
            for i in clip_indices:
                paths.extend(frame_paths_for(Path(self.cfg.CHALEARN.ROOT), self.crop_folder,
                                             nsetx3x5 / names[i]))
            return self._native.load_clip(paths, len(clip_indices), self.crop_size)
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


# -- host-sharded feeding (data parallelism over ranks, parallel/multihost.py) ---------


def train_batches_for_host(dataset, global_batch: int, seed: int = 0,
                           n_processes: Optional[int] = None, index: Optional[int] = None,
                           shuffle: bool = True, drop_last: bool = True) -> Iterator[Dict]:
    """Rank-local train feeding: {'x', 'label'} with this rank's rows only.

    Every rank runs this with the same ``seed``: the shuffled epoch order is
    the same everywhere, ``parallel.multihost.host_batch_indices`` hands rank
    p the contiguous sub-block p of each global batch, and each clip's
    ``random.Random`` comes from (seed, dataset index) alone, so a clip is
    the same whichever rank loads it. With ``n_processes=1`` this gives the
    global batches the ranks' rows concatenate to."""
    from ..parallel.multihost import host_batch_indices

    order = list(range(len(dataset)))
    if shuffle:
        pyrandom.Random(seed).shuffle(order)
    for block in host_batch_indices(order, global_batch, n_processes, index,
                                    drop_last=drop_last):
        samples = [dataset.get_train_clip(i, pyrandom.Random(seed * 1_000_003 + i))
                   for i in block]
        yield {"x": stack_clips([s["x"] for s in samples]),
               "label": np.asarray([s["label"] for s in samples], np.int32)}


class ShardedEvalPlan(NamedTuple):
    """The sharded eval's layout, the same on every rank and made from the
    clip counts alone (``num_eval_clips`` reads no frame).

    Rank q decodes only videos q, q+P, q+2P, ...; every rank runs
    ``n_steps`` steps of ``local_batch`` rows (all-padding tail batches keep
    the counts equal), and the gathered scores of rank q's rows go back to
    ``positions[q]``, the global video-major clip order."""

    n_processes: int
    local_batch: int          # rows each rank contributes per step
    n_steps: int
    samples_per_video: List[int]
    labels: np.ndarray        # (total_clips,) int32, global video-major order
    positions: List[np.ndarray]  # positions[q][j]: global index of rank q's j-th clip


def sharded_eval_plan(dataset, global_batch: int, n_processes: int) -> ShardedEvalPlan:
    if global_batch % n_processes:
        raise ValueError(f"global batch {global_batch} does not divide by {n_processes} ranks")
    spv = [dataset.num_eval_clips(i) for i in range(len(dataset))]
    offsets = np.concatenate([[0], np.cumsum(spv)]).astype(np.int64)
    labels = np.repeat(np.asarray([dataset.labels[i][2] - 1 for i in range(len(dataset))],
                                  np.int32), spv)
    positions = []
    for q in range(n_processes):
        pos = [np.arange(offsets[v], offsets[v + 1])
               for v in range(q, len(dataset), n_processes)]
        positions.append(np.concatenate(pos) if pos else np.zeros((0,), np.int64))
    local_batch = global_batch // n_processes
    n_steps = max((-(-len(p) // local_batch) for p in positions), default=0)
    return ShardedEvalPlan(n_processes, local_batch, max(n_steps, 1), spv, labels, positions)


def eval_batches_for_host(dataset, plan: ShardedEvalPlan, index: int,
                          seed: int = 0) -> Iterator[Dict]:
    """Rank ``index``'s share of the sharded eval: decodes only videos
    ``index, index+P, ...`` and yields exactly ``plan.n_steps`` batches of
    ``plan.local_batch`` rows ({'x', 'label', 'valid'}), the clips in
    eval_batches' per-video order and with its per-video clip RNG."""
    pending_x: list = []
    pending_y: List[int] = []
    emitted = 0
    lb = plan.local_batch

    def drain(final: bool):
        nonlocal pending_x, pending_y, emitted
        while len(pending_x) >= lb or (final and emitted < plan.n_steps):
            n = min(len(pending_x), lb)
            if n == 0:  # an all-padding step (other ranks still have rows)
                yield {"x": np.zeros((lb,) + dataset.sample_shape(), np.uint8),
                       "label": np.zeros(lb, np.int32), "valid": np.zeros(lb, bool)}
            else:
                valid = np.zeros(lb, bool)
                valid[:n] = True
                yield {"x": stack_clips(pending_x[:n] + [pending_x[0]] * (lb - n)),
                       "label": np.asarray(pending_y[:n] + [0] * (lb - n), np.int32),
                       "valid": valid}
                pending_x, pending_y = pending_x[n:], pending_y[n:]
            emitted += 1
            if emitted == plan.n_steps:
                return

    for v in range(index, len(dataset), plan.n_processes):
        item = dataset.get_eval_clips(v, pyrandom.Random(seed * 1_000_003 + v))
        if len(item["clips"]) != plan.samples_per_video[v]:
            raise AssertionError(f"video {v}: {len(item['clips'])} clips, "
                                 f"{plan.samples_per_video[v]} planned")
        pending_x.extend(item["clips"])
        pending_y.extend([item["label"]] * len(item["clips"]))
        yield from drain(final=False)
        if emitted == plan.n_steps:
            return
    yield from drain(final=True)
