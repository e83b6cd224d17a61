from .iuv_contract import IUVDetection, IUVProvider, SyntheticIUVProvider
from .online import (DensePoseOnlineDetector, OnlineVideoDataset, SyntheticOnlineDetector,
                     make_online_detector)
from .stages import (filter_img_by_flow, image_to_padded, iuv_to_crop, padded_to_cse,
                     padded_to_iuv, run_full_pipeline, sample_data, video_to_flow,
                     video_to_images)

__all__ = ["DensePoseOnlineDetector", "IUVDetection", "IUVProvider", "OnlineVideoDataset",
           "SyntheticIUVProvider", "SyntheticOnlineDetector", "filter_img_by_flow",
           "image_to_padded", "iuv_to_crop", "make_online_detector", "padded_to_cse",
           "padded_to_iuv", "run_full_pipeline", "sample_data", "video_to_flow",
           "video_to_images"]
