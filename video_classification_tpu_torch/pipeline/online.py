"""Online path: raw M_/K_ videos -> model-ready clips, nothing on disk.

Port of the JAX package's ``pipeline/online.py``: decode a video pair (or
take decoded frames), cut a random train window or the stride-4 eval windows
of ``CLIP_LEN`` sampled frames (every IMG_SAMPLE_INTERVAL-th raw frame),
detect per sampled
frame (cached per raw frame), and run the device preprocessing
(``device_pipeline.preprocess_clip_on_device``) on each window's raw frames.
The detector is ``synthetic`` (deterministic geometry) or ``densepose``
(``DensePoseOnlineDetector``: the DensePose R-CNN of ``detect/``).

For each sampled frame the window carries its ``interval-1`` preceding raw
frames, plus one extra leading frame, so the flow computes the same F0..F4
companions the offline chain stores (chalearn_iuv_to_crop.py:25-59).
"""

from __future__ import annotations

import random as pyrandom
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.crop_cfg import crop_part_args, crop_resize_dict
from ..data.dataset import MISSING_FILL, NUM_MODALITY_CHANNELS
from ..ops.flow import FlowParams
from ..ops.sampling import num_uniform_clips, random_clip_indices, uniform_clip_indices
from ..utils.cuda import resolve_device
from ..utils.labels import SETS, get_labels
from .device_pipeline import Detections, preprocess_clip_on_device

# detectron2 Base-RCNN-FPN pixel means of caffe2 (MSRA) backbones, BGR, unit
# std (the JAX package's detect/provider.PIXEL_MEAN).
PIXEL_MEAN = (103.53, 116.28, 123.675)


def flow_params_from_cfg(cfg) -> FlowParams:
    return FlowParams(
        n_outer=int(cfg.DATA.FLOW_OUTER),
        n_sor=int(cfg.DATA.FLOW_SOR),
        min_width=int(cfg.DATA.FLOW_MIN_WIDTH),
    )


class SyntheticOnlineDetector:
    """Deterministic detections: centred body box, banded part charts.

    The chart bands cover head (23), torso (1/2), arms (6/7) and hands (3/4)
    so every crop stream finds its component. Coordinates are in the
    2x-padded frame, the device pipeline's contract."""

    def __init__(self, heatmap_size: int = 56):
        self.heatmap_size = heatmap_size
        self._chart_cache: Optional[np.ndarray] = None

    def _charts(self) -> np.ndarray:
        if self._chart_cache is None:
            hm = self.heatmap_size
            c = np.zeros((hm, hm), np.int32)
            rows = np.broadcast_to(np.arange(hm)[:, None], (hm, hm))
            cols = np.broadcast_to(np.arange(hm)[None, :], (hm, hm))
            c[(rows < hm // 5)] = 23                                   # head
            c[(rows >= hm // 5) & (rows < 2 * hm // 5)] = 1            # torso
            c[(rows >= hm // 5) & (rows < 2 * hm // 5) & (cols >= hm // 2)] = 2
            arm_band = (rows >= 2 * hm // 5) & (rows < 3 * hm // 5)
            c[arm_band & (cols < hm // 2)] = 7                         # l arm
            c[arm_band & (cols >= hm // 2)] = 6                        # r arm
            hand_band = rows >= 3 * hm // 5  # generous: hand crops must clear
            c[hand_band & (cols < hm // 2)] = 4  # the >=15 px rule in tests
            c[hand_band & (cols >= hm // 2)] = 3
            self._chart_cache = c
        return self._chart_cache

    def __call__(self, padded_frames_bgr: torch.Tensor) -> Detections:
        """(S, 2H, 2W, 3) uint8 padded frames -> detections on their device."""
        s, ph, pw = padded_frames_bgr.shape[:3]
        dev = padded_frames_bgr.device
        h, w = ph // 2, pw // 2
        box = np.asarray([w * 0.6, h * 0.55, w * 1.4, h * 1.45], np.float32)
        hm = self.heatmap_size
        uu = np.linspace(0.0, 1.0, hm, dtype=np.float32)
        uv = np.stack([np.tile(uu, (hm, 1)), np.tile(uu[:, None], (1, hm))])
        return Detections(
            boxes_xyxy=torch.from_numpy(np.tile(box, (s, 1))).to(dev),
            valid=torch.ones((s,), dtype=torch.bool, device=dev),
            charts=torch.from_numpy(self._charts()).to(dev).expand(s, hm, hm),
            uv=torch.from_numpy(uv).to(dev).expand(s, 2, hm, hm),
        )


class DensePoseOnlineDetector:
    """DensePose R-CNN detections of the sampled (2x-padded) frames: per
    frame the best-scoring detection's box and validity, and the chart and
    U/V of detection 0, the one ``chart_topk=1`` computed (the keep order is
    score-descending), as the JAX package's detector returns them.

    Weights come from ``state_dict``, else from ``DATA.DENSEPOSE_PKL`` (a
    detectron2 pkl, ``detect/d2_convert.load_densepose_state_dict``), else,
    only with ``allow_random_init=True``, from a torch.Generator seeded with
    ``CUDA.SEED``. ``compute_dtype="auto"`` is bfloat16 on CUDA, float32 on the
    CPU. Frames run in chunks of ``batch_size``."""

    def __init__(self, cfg, state_dict=None, depth: int = 101,
                 pre_nms_topk: int = 256, post_nms_topk: int = 64,
                 max_detections: int = 8, chart_pooler_size: int = 28,
                 batch_size: int = 20, allow_random_init: bool = False,
                 compute_dtype: str = "auto", device=None):
        from ..detect.d2_convert import load_densepose_state_dict
        from ..detect.densepose import DensePoseRCNN, init_weights

        self.device = resolve_device(device)
        if state_dict is None and str(cfg.DATA.DENSEPOSE_PKL):
            state_dict = load_densepose_state_dict(cfg.DATA.DENSEPOSE_PKL, depth=depth)
        if state_dict is None and not allow_random_init:
            raise ValueError(
                "DensePoseOnlineDetector has no weights: set DATA.DENSEPOSE_PKL "
                "to a detectron2 model_final_*.pkl or pass state_dict=...; "
                "a randomly initialised detector gives meaningless crops, so "
                "callers that want one pass allow_random_init=True")
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        model = DensePoseRCNN(
            depth=depth, pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk,
            max_detections=max_detections, chart_pooler_size=chart_pooler_size,
            chart_topk=1, compute_dtype=getattr(torch, compute_dtype))
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(int(cfg.CUDA.SEED)))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.heatmap_size = model.heatmap_size
        self.batch_size = max(1, int(batch_size))
        self._mean = torch.tensor(PIXEL_MEAN, device=self.device)

    @torch.inference_mode()
    def __call__(self, padded_frames_bgr: torch.Tensor) -> Detections:
        """(S, 2H, 2W, 3) uint8 padded frames -> detections on the device."""
        x = (padded_frames_bgr.to(self.device).float() - self._mean).permute(0, 3, 1, 2)
        cols = []
        for start in range(0, x.shape[0], self.batch_size):
            res = self.model(x[start:start + self.batch_size].contiguous())
            best = torch.argmax(res["scores"], dim=1)
            rows = torch.arange(best.shape[0], device=best.device)
            cols.append((res["boxes"][rows, best], res["valid"][rows, best],
                         res["charts"][:, 0],
                         torch.stack([res["u"][:, 0], res["v"][:, 0]], dim=1)))
        boxes, valid, charts, uv = (torch.cat(c) for c in zip(*cols))
        return Detections(boxes_xyxy=boxes, valid=valid, charts=charts, uv=uv)


def make_online_detector(cfg, device=None):
    kind = str(cfg.DATA.ONLINE_DETECTOR)
    if kind == "synthetic":
        return SyntheticOnlineDetector()
    if kind == "densepose":
        # Raises unless DATA.DENSEPOSE_PKL is set: the config path never
        # serves from a randomly initialised detector. One chunk per clip's
        # CLIP_LEN sampled frames.
        return DensePoseOnlineDetector(
            cfg, batch_size=max(1, int(cfg.CHALEARN.CLIP_LEN)), device=device)
    raise ValueError(f"unknown DATA.ONLINE_DETECTOR: {kind}")


def _read_video(path, gray: bool) -> Optional[np.ndarray]:
    import cv2  # only needed to decode files

    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if gray:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[..., None]
            frames.append(frame)
    finally:
        cap.release()
    return np.stack(frames) if frames else None


class OnlineVideoDataset:
    """Train and eval clips of raw videos through the device preprocessing:
    the ``ChalearnVideoDataset`` contract (``get_train_clip``,
    ``get_eval_clips``, ``num_eval_clips``, ``__len__``), with clips on the
    device.

    ``labels`` lists (m_path, k_path, label) entries relative to
    ``CHALEARN.ROOT/CHALEARN.SAMPLE`` (absolute paths work too; a None k_path
    means no depth video); by default they are read from the set's label
    file (utils/labels.get_labels). ``videos`` maps an index to already
    decoded (rgb (T, H, W, 3), depth (T, H, W, 1) or None) uint8 frames,
    which skips decoding (without ``labels``, each gets label 1).
    ``timer`` (utils/profiling.StageTimer) records stage times: 'detect'
    here, 'flow' and 'crops' in the device pipeline."""

    def __init__(self, cfg, name_of_set: str, sampling: Optional[str] = None,
                 detector=None, flow_params: Optional[FlowParams] = None,
                 labels=None, videos: Optional[Dict[int, Tuple]] = None,
                 device=None, timer=None) -> None:
        if name_of_set not in SETS:
            raise ValueError(f"name_of_set must be one of {SETS}, got {name_of_set!r}")
        self.cfg = cfg
        self.name_of_set = name_of_set
        self.device = resolve_device(device)
        self.clip_len = int(cfg.CHALEARN.CLIP_LEN)
        self.interval = int(cfg.CHALEARN.IMG_SAMPLE_INTERVAL)
        self.crop_folder = cfg.MODEL.R3D_INPUT
        self.crop_size = crop_resize_dict[self.crop_folder]
        if labels is not None:
            self.labels = list(labels)
        elif videos is not None:
            self.labels = [(None, None, 1) for _ in sorted(videos)]
        else:
            self.labels = get_labels(cfg, name_of_set)
        self.sampling = sampling or ("random" if name_of_set == "train" else "uniform")
        self.detector = (detector if detector is not None
                         else make_online_detector(cfg, self.device))
        self.flow_params = flow_params or flow_params_from_cfg(cfg)
        self.timer = timer
        parts = [p for p in crop_part_args if p[1] == self.crop_folder]
        if not parts:
            raise ValueError(f"{self.crop_folder} is not a part-crop stream")
        self._parts = tuple(parts)
        self._videos = {index: self._to_device(rgb, depth)
                        for index, (rgb, depth) in (videos or {}).items()}
        self._decode_cache: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # Per-(video, raw frame) detections: stride-4 eval windows share
        # 16/20 sampled frames, so the detector sees each frame once.
        self._det_cache: Dict[int, Dict[int, Tuple]] = {}

    def __len__(self) -> int:
        return len(self.labels)

    def _to_device(self, rgb, depth) -> Tuple[torch.Tensor, torch.Tensor]:
        rgb = torch.as_tensor(rgb, dtype=torch.uint8)
        if rgb.dim() != 4 or rgb.shape[-1] != 3:
            raise ValueError(f"rgb frames must be (T, H, W, 3), got {tuple(rgb.shape)}")
        if depth is None or len(depth) != len(rgb):
            depth = torch.full(rgb.shape[:3] + (1,), MISSING_FILL, dtype=torch.uint8)
        depth = torch.as_tensor(depth, dtype=torch.uint8)
        return rgb.to(self.device), depth.to(self.device)

    def _decode(self, index: int) -> Tuple[torch.Tensor, torch.Tensor]:
        if index in self._videos:
            return self._videos[index]
        if index in self._decode_cache:
            return self._decode_cache[index]
        m_rel, k_rel, _ = self.labels[index]
        root = Path(self.cfg.CHALEARN.ROOT, self.cfg.CHALEARN.SAMPLE)
        rgb = _read_video(root / m_rel, gray=False)
        depth = _read_video(root / k_rel, gray=True) if k_rel else None
        if rgb is None:
            rgb = np.full((1, 64, 64, 3), MISSING_FILL, np.uint8)
        if len(self._decode_cache) >= 8:
            self._decode_cache.pop(next(iter(self._decode_cache)))
        self._decode_cache[index] = self._to_device(rgb, depth)
        return self._decode_cache[index]

    def _seq_len_sampled(self, index: int) -> int:
        n = self._decode(index)[0].shape[0]
        return max(-(-n // self.interval), 1)

    def _virtual_window(self, sampled_idx: List[int], t_video: int) -> np.ndarray:
        """Raw-frame indices of the virtual window: sampled frame k sits at
        virtual position (k+1)*interval, preceded by its interval-1 flow
        companions, and one extra leading frame makes position 1's flow the
        real pair (raw-interval, raw-interval+1); indices clamp at the video
        start."""
        iv = self.interval
        n = len(sampled_idx) * iv + 1
        raw = np.zeros((n,), np.int64)
        raw[0] = sampled_idx[0] * iv - iv
        for j in range(1, n):
            k = (j - 1) // iv
            delta = (k + 1) * iv - j
            raw[j] = sampled_idx[k] * iv - delta
        return np.clip(raw, 0, t_video - 1)

    def _detections_for(self, index: int, frames: torch.Tensor,
                        raw_sampled: np.ndarray) -> Detections:
        """Per-sampled-frame detections, cached by raw frame index; the
        detector only sees frames absent from the cache."""
        if index not in self._det_cache:
            if len(self._det_cache) >= 8:
                self._det_cache.pop(next(iter(self._det_cache)))
            self._det_cache[index] = {}
        cache = self._det_cache[index]
        missing = sorted({int(r) for r in raw_sampled} - cache.keys())
        if missing:
            h, w = frames.shape[1:3]
            padded = frames.new_zeros((len(missing), 2 * h, 2 * w, 3))
            padded[:, h // 2:h // 2 + h, w // 2:w // 2 + w] = frames[missing]
            stage = self.timer if self.timer is not None else (lambda _n: nullcontext())
            with stage("detect"):
                dets = self.detector(padded)
            for j, r in enumerate(missing):
                cache[r] = tuple(t[j] for t in dets)
        rows = [cache[int(r)] for r in raw_sampled]
        return Detections(*(torch.stack(col) for col in zip(*rows)))

    def _make_clip(self, index: int, sampled_idx: List[int]) -> torch.Tensor:
        """(S, size, size, 21) uint8 clip on the device."""
        rgb, depth = self._decode(index)
        raw_idx = self._virtual_window(sampled_idx, rgb.shape[0])
        s = len(sampled_idx)
        sampled_pos = np.arange(self.interval, len(raw_idx), self.interval)
        if len(sampled_pos) != s:
            raise AssertionError("virtual window lost a sampled frame")
        dets = self._detections_for(index, rgb, raw_idx[sampled_pos])
        idx = torch.from_numpy(raw_idx).to(self.device)
        out = preprocess_clip_on_device(
            rgb[idx], depth[idx], dets, interval=self.interval,
            parts=self._parts, flow_params=self.flow_params,
            sampled_start=self.interval, timer=self.timer)
        clip = out[self.crop_folder]
        if clip.shape != (s, self.crop_size, self.crop_size, NUM_MODALITY_CHANNELS):
            raise AssertionError(f"clip shape {tuple(clip.shape)}")
        return clip

    def get_train_clip(self, index: int, rng: pyrandom.Random) -> Dict:
        """One random CLIP_LEN window of video ``index``: {'x': (CLIP_LEN,
        size, size, 21) uint8 on the device, 'label': 0-based}."""
        idx = random_clip_indices(self._seq_len_sampled(index), self.clip_len, rng)
        return {"x": self._make_clip(index, idx), "label": self.labels[index][2] - 1}

    def get_eval_clips(self, index: int, rng: pyrandom.Random) -> Dict:
        seq = self._seq_len_sampled(index)
        clips = uniform_clip_indices(seq, self.clip_len, rng)
        return {"clips": [self._make_clip(index, ci) for ci in clips],
                "label": self.labels[index][2] - 1}

    def num_eval_clips(self, index: int) -> int:
        return num_uniform_clips(self._seq_len_sampled(index), self.clip_len)
