from .image import (NORM_MEAN, NORM_STD, cubic_resize, denormalize_to_uint8, normalize, pad2x,
                    pad_to_square_resize, random_crop, random_crop_batch)
from .sampling import (UNIFORM_STRIDE, num_uniform_clips, random_clip_indices,
                       random_clip_indices_device, uniform_clip_indices,
                       uniform_clip_indices_device)
from .segment import per_video_accuracy, per_video_scores, segment_ids_from_counts, softmax_scores

__all__ = ["NORM_MEAN", "NORM_STD", "UNIFORM_STRIDE", "cubic_resize", "denormalize_to_uint8",
           "normalize", "num_uniform_clips", "pad2x", "pad_to_square_resize",
           "per_video_accuracy", "per_video_scores", "random_clip_indices",
           "random_clip_indices_device", "random_crop", "random_crop_batch",
           "segment_ids_from_counts", "softmax_scores", "uniform_clip_indices",
           "uniform_clip_indices_device"]
