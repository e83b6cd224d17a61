"""Per-video score aggregation.

Port of the JAX package's ``ops/segment.py``: evaluation scores every
uniformly sampled clip, averages the softmax scores of each video's clips
and takes the argmax (train.py:337-364). The ragged clips-per-video
structure is a segment-id vector, so the aggregation is one segment mean.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def segment_ids_from_counts(samples_per_video: List[int],
                            total: Optional[int] = None) -> np.ndarray:
    """[3, 2, ...] -> [0, 0, 0, 1, 1, ...] int32."""
    ids = np.repeat(np.arange(len(samples_per_video)), samples_per_video)
    if total is not None and ids.shape[0] != total:
        raise ValueError(f"{ids.shape[0]} segment ids for {total} clips")
    return ids.astype(np.int32)


def per_video_scores(clip_scores: torch.Tensor, segment_ids: torch.Tensor,
                     num_videos: int) -> torch.Tensor:
    """Mean clip score per video: (N_clips, C) -> (num_videos, C)."""
    seg = torch.as_tensor(segment_ids, device=clip_scores.device).long()
    sums = clip_scores.new_zeros((num_videos, clip_scores.shape[1])).index_add_(
        0, seg, clip_scores)
    counts = clip_scores.new_zeros((num_videos,)).index_add_(
        0, seg, torch.ones_like(clip_scores[:, 0]))
    return sums / torch.clamp(counts, min=1.0)[:, None]


def per_video_accuracy(clip_scores: torch.Tensor, clip_labels: torch.Tensor,
                       segment_ids: torch.Tensor,
                       num_videos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Video-level top-1 accuracy with mean-score aggregation
    (train.py:344-364): (accuracy scalar, per-video correctness). A video's
    label is the minimum of its clips' labels (``segment_min``)."""
    seg = torch.as_tensor(segment_ids, device=clip_scores.device).long()
    labels = torch.as_tensor(clip_labels, device=clip_scores.device).long()
    preds = torch.argmax(per_video_scores(clip_scores, seg, num_videos), dim=-1)
    first = torch.full((num_videos,), torch.iinfo(torch.int64).max,
                       dtype=torch.int64, device=labels.device)
    first = first.scatter_reduce(0, seg, labels, reduce="amin")
    correct = preds == first
    return correct.float().mean(), correct


def softmax_scores(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over classes, in float32."""
    return torch.softmax(logits.float(), dim=-1)
