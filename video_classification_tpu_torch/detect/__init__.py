from .convert import state_dict_from_jax
from .d2_convert import (
    coverage_report,
    d2_key_shapes,
    load_d2_pkl,
    load_densepose_state_dict,
    synthesize_state_dict,
)
from .densepose import (
    ASPP,
    BoxHead,
    BoxPredictor,
    ChartPredictor,
    Decoder,
    DensePoseDeepLabHead,
    DensePoseRCNN,
    ResNetFPN,
    RPNHead,
    generate_anchors,
)
from .ops import apply_deltas, box_iou, clip_boxes, multilevel_roi_align, nms, roi_align
from .provider import DensePoseIUVProvider

__all__ = [
    "roi_align",
    "multilevel_roi_align",
    "nms",
    "box_iou",
    "apply_deltas",
    "clip_boxes",
    "ASPP",
    "BoxHead",
    "BoxPredictor",
    "ChartPredictor",
    "Decoder",
    "DensePoseDeepLabHead",
    "DensePoseIUVProvider",
    "DensePoseRCNN",
    "ResNetFPN",
    "RPNHead",
    "generate_anchors",
    "coverage_report",
    "d2_key_shapes",
    "load_d2_pkl",
    "load_densepose_state_dict",
    "state_dict_from_jax",
    "synthesize_state_dict",
]
