"""The IUV detection contract.

The reference consumes DensePose output through a narrow interface
(`chalearn_iuv_to_crop.py:105-106,207-213` of the reference): per frame,

  * ``pred_boxes_XYXY`` (n, 4) float — person candidate boxes (in the 2x-padded
    frame's coordinates),
  * ``scores`` (n,) float — detection confidence (argmax picks the person),
  * ``pred_densepose.labels`` (h_box, w_box) int — the 0..24 body-part chart index
    per pixel *inside the selected box*,
  * ``pred_densepose.uv`` (2, h_box, w_box) float in [0, 1] — per-pixel UV chart
    coordinates inside the box.

Any detector satisfying ``IUVProvider`` plugs into the crop stage. Implementations:
``SyntheticIUVProvider`` (deterministic geometry for tests/fixtures) and the
DensePose R-CNN (``detect/provider.DensePoseIUVProvider``).
A numpy copy of the JAX package's ``pipeline/iuv_contract.py``: the port
imports nothing from it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Protocol, Sequence

import numpy as np


@dataclasses.dataclass
class IUVDetection:
    """Detection result for one frame (numpy; the reference pickles GPU tensors —
    noted as a defect at chalearn_padded_to_iuv.py:76)."""

    boxes_xyxy: np.ndarray   # (n, 4) float32
    scores: np.ndarray       # (n,) float32
    labels: np.ndarray       # (h_box, w_box) uint8, chart of the best box
    uv: np.ndarray           # (2, h_box, w_box) float32 in [0, 1]
    file_name: str = ""

    def best_box(self):
        if self.boxes_xyxy.shape[0] == 0:
            return None
        return self.boxes_xyxy[int(np.argmax(self.scores))].astype(int)


class IUVProvider(Protocol):
    def detect(self, images: np.ndarray, file_names: Sequence[str]) -> List[IUVDetection]:
        """images: (B, H, W, 3) uint8 (2x-padded frames)."""
        ...


class SyntheticIUVProvider:
    """Deterministic stand-in detector for tests and fixtures.

    Places a 'person' box covering the central half of the padded frame and fills
    it with a plausible chart layout: torso (1) center, head (23) top, hands (4/3)
    at the lower corners, arms (15/16) between — every part >= 15 px so the crop
    stage's min-size rule passes.
    """

    def detect(self, images: np.ndarray, file_names: Sequence[str]) -> List[IUVDetection]:
        out = []
        for i in range(images.shape[0]):
            h, w = images.shape[1:3]
            x1, y1, x2, y2 = w // 4, h // 4, 3 * w // 4, 3 * h // 4
            bh, bw = y2 - y1, x2 - x1
            labels = np.zeros((bh, bw), np.uint8)
            # torso: central block
            labels[bh // 4 : 3 * bh // 4, bw // 4 : 3 * bw // 4] = 1
            # head: top strip
            labels[: bh // 5, 2 * bw // 5 : 3 * bw // 5] = 23
            # arms: side columns
            labels[bh // 4 : 3 * bh // 4, : bw // 5] = 15
            labels[bh // 4 : 3 * bh // 4, 4 * bw // 5 :] = 16
            # hands: bottom corners
            hs = max(16, bh // 5)
            labels[-hs:, :hs] = 4
            labels[-hs:, -hs:] = 3
            yy, xx = np.mgrid[0:bh, 0:bw]
            uv = np.stack([xx / max(bw - 1, 1), yy / max(bh - 1, 1)]).astype(np.float32)
            out.append(
                IUVDetection(
                    boxes_xyxy=np.asarray([[x1, y1, x2, y2]], np.float32),
                    scores=np.asarray([0.99], np.float32),
                    labels=labels,
                    uv=uv,
                    file_name=file_names[i] if i < len(file_names) else "",
                )
            )
        return out
