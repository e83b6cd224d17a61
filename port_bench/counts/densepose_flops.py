"""DensePose R-CNN FLOPs of a frame, counted on the reference detector.

``torch.utils.flop_counter.FlopCounterMode`` over the dense parts of
``reference.densepose.DensePose`` on meta tensors, at the shapes the serving
budget fixes: the backbone, the FPN, the RPN head and the DensePose decoder
on one frame padded to a multiple of 64, the box head on ``proposals``
pooled proposals, and the DeepLab head and chart predictor on ``charts``
pooled chart boxes. The convolutions' and linear layers' multiply-adds, two
FLOPs each, from the shapes alone; ROIAlign, top-k, NMS and the
element-wise steps are not counted. On meta tensors no weight or
activation is made: a count takes well under a second. R101 on one 480x640
frame (512x640 padded), 64 proposals and one chart box reads 250.624 GFLOP.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.densepose import FPN, DensePose, layout


@functools.lru_cache(maxsize=None)
def frame_flops(depth: int, height: int, width: int, proposals: int, charts: int,
                chart_pooler_size: int) -> float:
    """Forward FLOPs of the detector on one ``height`` x ``width`` frame."""
    with torch.device("meta"):
        state = {k: torch.empty(shape) for k, (shape, _) in layout(depth).items()}
        det = DensePose(state, depth, chart_pooler_size=chart_pooler_size)
        with FlopCounterMode(display=False) as counter:
            feats = det.features(torch.empty(1, 3, height, width))
            det.rpn_head(feats)
            det.decoder(feats)
            det.box_head(torch.empty(proposals, FPN, 7, 7))
            det.chart_head(torch.empty(charts, FPN, chart_pooler_size, chart_pooler_size))
    return float(counter.get_total_flops())
