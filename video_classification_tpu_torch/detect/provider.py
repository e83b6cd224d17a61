"""IUV provider backed by the port's DensePose R-CNN.

Port of the JAX package's ``detect/provider.py``: the offline chain's
detector (``pipeline/stages.padded_to_iuv``). Per frame it returns the
valid detections and the chart (nearest) and U/V (bilinear) of the best one,
resized from heatmap resolution to the box's size: what the reference's
crop stage consumes (chalearn_iuv_to_crop.py:105-106,207-213).

Input handling is detectron2's DefaultPredictor for the released caffe2
R-101 model: BGR input, mean subtraction with unit std, and
ResizeShortestEdge(min_size, max_size) with detections scaled back to the
frame; ``min_size=0`` skips the resize. The resize (OpenCV's INTER_LINEAR,
bit-exact: ``ops/image.resize_linear_u8``), the mean subtraction and the
chunks of ``batch_size`` frames run on the device; each chunk's outputs come
to the host as it completes (``utils/chunked.run_chunked``). The post-processing is the
JAX provider's numpy code, with its two per-frame ``cv2.resize`` calls done
on the device (``ops/image.resize_nearest``, ``resize_linear_f32``).

Weights come from ``state_dict``, from the JAX package's ``variables``
(``detect/convert.state_dict_from_jax``), or from a detectron2 pkl
(``weights_pkl``, ``detect/d2_convert.load_densepose_state_dict``); seeded
random weights only with ``allow_random_init=True``. Unlike the JAX
provider, which initialises random weights silently when given none, a
provider without weights raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.image import resize_linear_f32, resize_linear_u8, resize_nearest
from ..pipeline.iuv_contract import IUVDetection
from ..pipeline.online import PIXEL_MEAN
from ..utils.chunked import run_chunked
from ..utils.cuda import resolve_device


def resized_shape(h: int, w: int, min_size: int, max_size: int):
    """(scale, (nh, nw)) of ResizeShortestEdge; Python's round sizes it, as
    in the JAX provider."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return scale, (int(round(h * scale)), int(round(w * scale)))


class DensePoseIUVProvider:
    def __init__(self, state_dict=None, variables=None, weights_pkl: Optional[str] = None,
                 depth: int = 101, rng_seed: int = 0, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 1000, max_detections: int = 100,
                 chart_pooler_size: int = 28, min_size: int = 800, max_size: int = 1333,
                 compute_dtype: str = "auto", batch_size: int = 8, chart_topk: int = 1,
                 allow_random_init: bool = False, device=None):
        from .convert import state_dict_from_jax
        from .d2_convert import load_densepose_state_dict
        from .densepose import DensePoseRCNN, init_weights

        self.device = resolve_device(device)
        if state_dict is None and variables is not None:
            state_dict = state_dict_from_jax(variables)
        if state_dict is None and weights_pkl is not None:
            state_dict = load_densepose_state_dict(weights_pkl, depth=depth)
        if state_dict is None and not allow_random_init:
            raise ValueError(
                "DensePoseIUVProvider has no weights: pass weights_pkl (a detectron2 "
                "model_final_*.pkl), variables or state_dict; a randomly initialised "
                "detector gives meaningless IUV, so callers that want one pass "
                "allow_random_init=True")
        # bfloat16 on the accelerator, as the JAX provider's 'auto'.
        if compute_dtype == "auto":
            compute_dtype = "bfloat16" if self.device.type == "cuda" else "float32"
        # chart_topk=1: only the best detection's chart is consumed (the
        # reference's argmax-score policy, chalearn_iuv_to_crop.py:212-213).
        model = DensePoseRCNN(
            depth=depth, pre_nms_topk=pre_nms_topk, post_nms_topk=post_nms_topk,
            max_detections=max_detections, chart_pooler_size=chart_pooler_size,
            chart_topk=chart_topk, compute_dtype=getattr(torch, compute_dtype))
        if state_dict is None:
            init_weights(model, torch.Generator().manual_seed(int(rng_seed)))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.min_size = min_size
        self.max_size = max_size
        self.batch_size = max(1, int(batch_size))
        self._mean = torch.tensor(PIXEL_MEAN, device=self.device)

    def _prepare(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device -> the model's (B, 3, h, w)
        float32 input: resized, mean-subtracted, channels first."""
        if self.min_size:
            h, w = frames.shape[1:3]
            _, hw = resized_shape(h, w, self.min_size, self.max_size)
            if hw != (h, w):
                frames = resize_linear_u8(frames, hw)
        return (frames.float() - self._mean).permute(0, 3, 1, 2).contiguous()

    @torch.inference_mode()
    def _infer(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        frames = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        res = run_chunked(lambda chunk: self.model(self._prepare(chunk)), frames,
                          self.batch_size, to_host=True)
        return {k: v.numpy() for k, v in res.items()}

    @torch.inference_mode()
    def _to_box(self, chart: np.ndarray, u: np.ndarray, v: np.ndarray, bh: int, bw: int):
        """The chart (nearest) and U, V (bilinear) of one detection at box size."""
        dev = self.device
        labels = resize_nearest(torch.from_numpy(chart).to(dev)[None], (bh, bw))[0]
        uv = resize_linear_f32(torch.from_numpy(np.stack([u, v])).to(dev), (bh, bw))
        return labels.cpu().numpy(), uv.cpu().numpy()

    def detect(self, images: np.ndarray, file_names: Sequence[str]) -> List[IUVDetection]:
        """images: (B, H, W, 3) uint8 (2x-padded BGR frames)."""
        n = images.shape[0]
        if n == 0:
            return []
        h, w = images.shape[1:3]
        scale = 1.0
        if self.min_size:
            s, hw = resized_shape(h, w, self.min_size, self.max_size)
            scale = s if hw != (h, w) else 1.0
        results = self._infer(images)

        out: List[IUVDetection] = []
        for i in range(n):
            res = {k: a[i] for k, a in results.items()}
            valid = res["valid"]
            boxes = res["boxes"][valid] / scale  # back to the frame's coordinates
            scores = res["scores"][valid]
            name = file_names[i] if i < len(file_names) else ""
            if boxes.shape[0] == 0:
                out.append(IUVDetection(
                    boxes_xyxy=np.zeros((0, 4), np.float32),
                    scores=np.zeros((0,), np.float32),
                    labels=np.zeros((0, 0), np.uint8),
                    uv=np.zeros((2, 0, 0), np.float32),
                    file_name=name))
                continue
            best = int(np.argmax(scores))
            x1, y1, x2, y2 = boxes[best].astype(int)
            bw, bh = max(int(x2 - x1), 1), max(int(y2 - y1), 1)
            # The keep order is score-descending, so the best valid detection
            # is row 0, which chart_topk guarantees has a chart; the min
            # guards chart_topk=0 (every row has one).
            row = min(int(np.flatnonzero(valid)[best]), res["charts"].shape[0] - 1)
            labels, uv = self._to_box(res["charts"][row].astype(np.uint8),
                                      res["u"][row], res["v"][row], bh, bw)
            out.append(IUVDetection(
                boxes_xyxy=boxes.astype(np.float32),
                scores=scores.astype(np.float32),
                labels=labels,
                uv=uv.astype(np.float32),
                file_name=name))
        return out
